"""Hub-and-spoke cylinders of the port (mirror of
`mpisppy_tpu/cylinders`): the PH, APH and L-shaped hubs, the
Lagrangian, Lagranger and Frank-Wolfe outer-bound spokes, and the xhat,
L-shaped xhat and slam inner-bound spokes, and the cross-scenario cut
spoke, on one device; `proc.py` runs spokes as separate processes
(multiproc mode)."""
