"""The port's data helpers; the names the JAX package's `data` exports."""
from .grids import merge_time_grids, sort_time_series
from .neighbours import maximin_ordering, nearest_neighbour_sets
from .transformed import AffineTransform, BoxCoxTransform, LogTransform, TransformedData
