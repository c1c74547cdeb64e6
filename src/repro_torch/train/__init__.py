from .step import make_decode_step, make_prefill_step, make_train_step
from .trainer import (Trainer, TrainerConfig,
                      TrainingDivergedError, Watchdog)
