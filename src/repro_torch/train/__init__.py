"""Training (port of ``repro.train``)."""
from repro_torch.train.loop import TrainConfig, TrainState, make_train_step  # noqa: F401
