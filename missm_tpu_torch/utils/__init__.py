from .prefetch import Prefetcher, prefetch
from .profiling import StepTimer, trace
