"""The program's side of each configuration kind: the scene built through
the program's public ``SceneBuilder``, as a user builds it, from a
configuration file. One module per kind, found by the configuration's
``kind``."""
