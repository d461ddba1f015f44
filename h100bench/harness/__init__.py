"""The benchmark's own code: it finds each cell's configuration, its
family's reference and program adapter, the traffic mix and its driver,
the per-layer readers and the limits by name (:mod:`.spec`), draws the
traffic (:mod:`.lidar`) and the weights (:mod:`.weights`) from the seed,
drives the program's entry point (one driver a kind of mix, such as
:mod:`.serve_batch`), reduces the profiler's trace (:mod:`.trace`) and the
window's timings (:mod:`.stats`), and judges the program's answers against
the plain reference (:mod:`.compare`). Nothing here imports JAX or the JAX
package (:mod:`.guard` checks the process), the port, or a family's
reference by its name."""
