"""The plain reference the benchmark judges the program's outputs by.

Plain PyTorch and numpy, written from the upstream solver's equations
(PositionBasedDynamics: ``TimeIntegration.cpp``, ``XPBD.cpp``,
``TimeStepController.cpp``; FluidDemo's ``TimeStepFluidModel.cpp`` and
``PositionBasedFluids.cpp``) and the configuration files under
``benchmark/configs/``. It imports nothing of the program under test, of
the JAX package or of JAX: every derived quantity (rest lengths, bending
factors, inverse rest matrices, volumes, Jacobi counts, inverse masses,
boundary ψ weights, neighbourhoods) is worked out again here from a
configuration. One module per configuration kind (``grid_cloth``,
``grid_tet``, ``pbf_dam``) and one for the planner period (``mppi``);
``xpbd`` holds what the XPBD kinds share.
"""
