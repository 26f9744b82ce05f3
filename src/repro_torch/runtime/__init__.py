"""Train and serve steps, the training runner and its data staging
(``repro.runtime`` counterpart).  The reference's ``make_slot_*`` jitted
factories have no counterpart here: the port's slot steps are plain
functions in :mod:`repro_torch.runtime.step`."""

from .pipeline import PeriodPrefetcher, stack_period_batches
from .runner import (PeriodGraphStats, Runner, RunnerConfig,
                     reshard_train_state)
from .step import (StepConfig, TrainState, compose_makeup_step,
                   init_train_state, make_decode_step, make_period_step,
                   make_phase_steps, make_prefill_step, make_train_step)

__all__ = ["PeriodGraphStats", "PeriodPrefetcher", "Runner", "RunnerConfig",
           "StepConfig", "TrainState", "compose_makeup_step",
           "init_train_state", "make_decode_step", "make_period_step",
           "make_phase_steps", "make_prefill_step", "make_train_step",
           "reshard_train_state", "stack_period_batches"]
