"""Training (counterpart of ``repro.train``): the optimizer (float32,
bfloat16 or int8 moments, float32 masters), the synthetic data stream, the
checkpoint manager, and the train step and fault-tolerant loop."""
from .checkpoint import CheckpointManager
from .data import SyntheticData
from .optimizer import AdamWConfig, adamw_init, adamw_update
