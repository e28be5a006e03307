"""Hub-and-spoke cylinders of the port (mirror of
`mpisppy_tpu/cylinders`): the PH hub, the Lagrangian and Lagranger
outer-bound spokes, and the xhat and slam inner-bound spokes, on one
device.  Not ported yet: `cross_scen_spoke` (ROADMAP.md queue A item
11), the fwph and L-shaped cylinders and `APHHub` (item 10), and
multiproc spokes (`proc.py`, item 11)."""
