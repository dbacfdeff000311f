from .prefetch import Prefetcher, prefetch
from .profiling import count, counters, span, trace
