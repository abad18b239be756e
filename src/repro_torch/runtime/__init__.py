"""Fault-tolerant runtime (port of ``repro.runtime``, single device)."""
from .fault_tolerance import (FailureInjector, InjectedFailure,
                              ResilientLoop, StragglerWatchdog)

__all__ = ["ResilientLoop", "FailureInjector", "InjectedFailure",
           "StragglerWatchdog"]
