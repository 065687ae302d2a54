from skypilot_tpu_torch.train.trainer import (Optimizer, TrainConfig,
                                              Trainer, synthetic_batches)

__all__ = ['Optimizer', 'TrainConfig', 'Trainer', 'synthetic_batches']
