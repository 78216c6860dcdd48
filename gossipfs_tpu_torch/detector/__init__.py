"""Failure detectors behind the ``FailureDetector`` seam (detector/api.py):
the simulated cluster on the round loops (detector/sim.py)."""
