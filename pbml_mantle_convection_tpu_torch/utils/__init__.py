# the JAX package's utils/jit.py (XLA compiler options) has no counterpart
from .checkpoint import (  # noqa: F401
    load_pickle, restore_checkpoint, save_checkpoint, save_pickle)
from .evaluation import (  # noqa: F401
    compare_rollouts, field_mae, inference_latency, model_error_sweep,
    pearson, speedup_table, temperature_rmse)
from .profiling import trace  # noqa: F401
