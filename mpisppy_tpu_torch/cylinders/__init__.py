"""Hub-and-spoke cylinders of the port (mirror of
`mpisppy_tpu/cylinders`): the PH, APH and L-shaped hubs, the
Lagrangian, Lagranger and Frank-Wolfe outer-bound spokes, and the xhat,
L-shaped xhat and slam inner-bound spokes, on one device.  Not ported
yet: `cross_scen_spoke` and multiproc spokes (`proc.py`), ROADMAP.md
queue A item 11."""
