"""Engine telemetry: device-resident counters (the token counter so far)."""
from repro_torch.telemetry.counters import (COUNTER_KEYS, bump, counter_totals,
                                            init_counters)

__all__ = ["COUNTER_KEYS", "init_counters", "bump", "counter_totals"]
