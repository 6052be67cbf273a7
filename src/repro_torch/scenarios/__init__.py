"""Scripted, time-varying workloads and fleets (port of
``repro/scenarios``): ``spec`` (the event DSL and registry), ``compile``
(tables on the device) and ``runtime`` (clock lookup, cap-shrink
eviction, the cached ``for_cfg``).  The failure response (drain, retry,
shed) is ``repro_torch.env.failover``."""
from repro_torch.scenarios.compile import ScenarioTensors, compile_spec  # noqa: F401
from repro_torch.scenarios.runtime import (at_time, availability,  # noqa: F401
                                           compiled, evict_beyond_cap,
                                           for_cfg)
from repro_torch.scenarios.spec import (CapClaim, DiurnalRate,  # noqa: F401
                                        ExpertDown, FlashCrowd, ScenarioSpec,
                                        Slowdown, TraceReplay, get, names,
                                        register)
