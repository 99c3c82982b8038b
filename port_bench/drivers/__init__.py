"""Drivers, one module an entry point the window drives.  Each has a
`Cell(config, mix, seed, device)`, which builds the program's objects
from the seed's inputs and warms up the cell's own shapes, with
`window(seconds)`, `trace_units` and `run(units)` (the fixed units the
traced readings take, the same for every seed), `release()` (frees what
the check does not judge) and `check(trace)` (runs the reference and
returns the numbers compared and, for a traced run, the work the
roofline readers count)."""
