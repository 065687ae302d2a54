from skypilot_tpu_torch.train.trainer import (Optimizer, TrainConfig,
                                              Trainer, make_optimizer,
                                              synthetic_batches)

__all__ = ['Optimizer', 'TrainConfig', 'Trainer', 'make_optimizer',
           'synthetic_batches']


def __getattr__(name):
    # Lazy submodule access (sft / dpo / lora / rl), as the JAX package's
    # train/__init__.py.
    if name in ('sft', 'dpo', 'lora', 'rl'):
        import importlib
        return importlib.import_module(f'skypilot_tpu_torch.train.{name}')
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
