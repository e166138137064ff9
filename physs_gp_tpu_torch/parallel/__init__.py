"""Time-axis sharding over a `torch.distributed` DeviceMesh (`sharded`), the
launch of ranks for it (`ranks`) and the multi-rank dryrun (`dryrun`)."""
from .sharded import sharded_filter_smoother, sharded_sqrt_filter_smoother  # noqa: F401
