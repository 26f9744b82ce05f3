"""Train and serve steps, the training runner and its data staging
(``repro.runtime`` counterpart)."""

from .pipeline import PeriodPrefetcher, stack_period_batches
from .runner import Runner, RunnerConfig, reshard_train_state
from .step import (StepConfig, TrainState, compose_makeup_step,
                   init_train_state, make_phase_steps, make_train_step)

__all__ = ["PeriodPrefetcher", "Runner", "RunnerConfig", "StepConfig",
           "TrainState", "compose_makeup_step", "init_train_state",
           "make_phase_steps", "make_train_step", "reshard_train_state",
           "stack_period_batches"]
