"""Learning-rate schedulers.

The port's copy of `mxnet_tpu/lr_scheduler.py` (the reference's
`python/mxnet/lr_scheduler.py`): plain Python over update counts, the
same in both packages.
"""
from __future__ import annotations

import logging

from .base import MXNetError

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler"]


class LRScheduler:
    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update):
        raise NotImplementedError()


class FactorScheduler(LRScheduler):
    """lr *= factor every `step` updates (`lr_scheduler.py` FactorScheduler)."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise MXNetError("schedule step must be >= 1")
        if factor > 1.0:
            raise MXNetError("factor must be <= 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        # lazy decay: apply every step boundary crossed since the last
        # query at once, so a run resumed at update K lands on the same lr
        # as one that queried every update
        boundaries_passed = max(0, (num_update - 1 - self.count) // self.step)
        if not boundaries_passed:
            return self.base_lr
        self.count += boundaries_passed * self.step
        decayed = self.base_lr * self.factor ** boundaries_passed
        if decayed < self.stop_factor_lr:
            self.base_lr = self.stop_factor_lr
            logging.info("Update[%d]: lr hit the stop floor; holding %0.5e",
                         num_update, self.base_lr)
        else:
            self.base_lr = decayed
            logging.info("Update[%d]: learning rate decayed to %0.5e",
                         num_update, self.base_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """lr *= factor at given update milestones (`lr_scheduler.py`
    MultiFactorScheduler)."""

    def __init__(self, step, factor=1):
        super().__init__()
        if not isinstance(step, list) or len(step) < 1:
            raise MXNetError("step must be a non-empty list of milestones")
        for i, s in enumerate(step):
            if i and s <= step[i - 1]:
                raise MXNetError("milestones must be increasing")
            if s < 1:
                raise MXNetError("milestones must be >= 1")
        if factor > 1.0:
            raise MXNetError("factor must be <= 1")
        self.step = step
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
                logging.info("Update[%d]: Change learning rate to %0.5e",
                             num_update, self.base_lr)
            else:
                return self.base_lr
        return self.base_lr
