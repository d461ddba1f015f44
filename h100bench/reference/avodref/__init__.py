"""The ``avod`` family's plain reference: ``plain.py`` is AVOD's forward
pass in plain PyTorch, importing nothing of the program or of JAX. It is
the one copy: the repository's tests import it (``tests/avod_reference.py``
re-exports it), so the benchmark's yardstick and the tests' are the same
code."""
