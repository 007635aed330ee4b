"""The program's side of each configuration kind: the scene built through
the program's public entry points (``SceneBuilder``; for fluids
``FluidScene.create``), as a user builds it, from a configuration file,
and for a kind that ``make_step_fn`` does not step, a ``Drive`` that steps
it through its own entry point. One module per kind, found by the
configuration's ``kind``."""
