"""The analytic Atleus model (paper Table IV, Eqs. 5-11, Figs. 6, 8, 10-15):
the port's own copy of ``repro.perfmodel``.

Standard library only. The modules are the JAX package's, line for line,
with their imports pointed here, so that the port imports nothing of
``repro``; ``tests/test_torch_perfmodel.py`` holds every public function
and constant to the original's numbers exactly.
"""
