"""A frozen copy of the port's plain code, the benchmark's reference: the
configuration tree, the networks and the ops, with the kernels' plain
versions in ``ops/plain.py``. Nothing here imports the program."""
