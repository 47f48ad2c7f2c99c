from .trainer import StragglerMonitor, Trainer, TrainResult, make_train_step

__all__ = ["StragglerMonitor", "Trainer", "TrainResult", "make_train_step"]
