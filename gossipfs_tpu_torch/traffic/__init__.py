"""The traffic plane's event-side pieces (pure Python).

The port's copies of what the streaming monitor and the analyzer need
from the JAX package's ``gossipfs_tpu/traffic/``: ``audit.py`` (the
durability replay over flight-recorder events) and ``workload.quantiles``.
The workload generator, the planner and the harness are not ported yet
(ROADMAP Queue 1, items 6-7).
"""
