"""Fault-tolerant runtime (port of ``repro.runtime``)."""
from .fault_tolerance import (ElasticController, FailureInjector,
                              InjectedFailure, ResilientLoop,
                              StragglerWatchdog)

__all__ = ["ResilientLoop", "FailureInjector", "InjectedFailure",
           "StragglerWatchdog", "ElasticController"]
