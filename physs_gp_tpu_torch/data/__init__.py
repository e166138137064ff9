"""The port's data helpers; the names the JAX package's `data` exports, as
far as they are ported (`data/neighbours.py` is not)."""
from .grids import merge_time_grids, sort_time_series
from .transformed import AffineTransform, BoxCoxTransform, LogTransform, TransformedData
