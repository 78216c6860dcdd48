"""Failure detectors behind the ``FailureDetector`` seam (detector/api.py):
the simulated cluster on the round loops (detector/sim.py) and the asyncio
cluster over real localhost datagrams (detector/udp.py).  Import the
modules themselves: this package imports neither, as in the JAX package."""
