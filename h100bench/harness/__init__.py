"""The benchmark's own code: it finds each cell's configuration, traffic
mix, per-layer readers and limits by name (:mod:`.spec`), draws the
traffic (:mod:`.lidar`) and the weights (:mod:`.weights`) from the seed,
drives the program's entry point (:mod:`.serve`), reduces the profiler's
trace (:mod:`.trace`) and the window's timings (:mod:`.stats`), and judges
the program's answers against the plain reference (:mod:`.compare`).
Nothing here imports JAX or the JAX package (:mod:`.guard` checks the
process)."""
