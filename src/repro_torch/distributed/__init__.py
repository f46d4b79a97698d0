"""Host-side fault-tolerance pieces of the port (``fault.py``, a copy of
``repro/distributed/fault.py``).  Collectives and elastic resharding come
with the port's distribution slice."""
from repro_torch.distributed.fault import StepTimeMonitor, retry_transient

__all__ = ["StepTimeMonitor", "retry_transient"]
