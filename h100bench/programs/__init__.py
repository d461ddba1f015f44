"""The program adapters: ``<family>.py`` turns a cell's configuration
tree and weights into the served call the window drives, through the
port's own entry points. They are the benchmark's only files outside
``reference/`` and ``checks/`` that import the port's model, export or
load functions."""
