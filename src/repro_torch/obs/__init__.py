from repro_torch.obs.registry import (Counter, Family, Gauge, Histogram,
                                      MetricsRegistry)

__all__ = ["Counter", "Family", "Gauge", "Histogram", "MetricsRegistry"]
