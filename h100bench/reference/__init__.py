"""The plain reference the benchmark judges the program against.

``mv3dref`` is a frozen copy of the program's plain PyTorch code (the
configuration tree, the networks, the voxelizer, anchors, proposals, NMS,
ROI-align and the detection decode), with the plain versions of the four
kernels in place of the ``mv3d::`` operators (``mv3dref/ops/plain.py``).
It imports nothing of the program, of the JAX package or of JAX, and
takes nothing the program made: it voxelizes the raw clouds itself and
loads the weights the benchmark drew. :mod:`.mv3d` is the ``mv3d``
family's module: its lidar -> boxes function on raw frames, as the served
program's signature states it, and what the harness needs to know of the
family. A later family brings its own ``<family>.py`` beside it.
"""
