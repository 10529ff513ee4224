"""Learning-rate schedules keyed on the optimizer's update count.

This package's own copy of ``mxnet_tpu/lr_scheduler.py`` (``LRScheduler``
:15, ``FactorScheduler`` :25, ``MultiFactorScheduler`` :55,
``PolyScheduler`` :84, ``CosineScheduler`` :102): plain Python, so the
two packages give the same learning rate at every update.  An
``Optimizer`` built with ``lr_scheduler=`` sets the scheduler's
``base_lr`` to its ``learning_rate`` and asks it for the rate at each
update count.
"""
from __future__ import annotations

import logging
import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    """Maps ``num_update`` to a learning rate; mutates ``base_lr`` as it
    decays."""

    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update):
        raise NotImplementedError()


class FactorScheduler(LRScheduler):
    """Multiply lr by ``factor`` once per ``step`` updates, flooring at
    ``stop_factor_lr`` (ref lr_scheduler.py:21)."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise ValueError("schedule step must be >= 1")
        if factor > 1.0:
            raise ValueError("factor must be <= 1 so the lr decays")
        self.step, self.factor = step, factor
        self.stop_factor_lr, self.count = stop_factor_lr, 0

    def __call__(self, num_update):
        # catch up on every boundary the update counter has crossed
        while self.count + self.step < num_update:
            self.count += self.step
            decayed = self.base_lr * self.factor
            if decayed < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
                logging.info("Update[%d]: now learning rate arrived at "
                             "%0.5e, will not change in the future",
                             num_update, self.base_lr)
            else:
                self.base_lr = decayed
                logging.info("Update[%d]: Change learning rate to %0.5e"
                             % (num_update, self.base_lr))
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """Multiply lr by ``factor`` at each boundary in an increasing list
    (ref lr_scheduler.py:62)."""

    def __init__(self, step, factor=1):
        super().__init__()
        if not isinstance(step, list) or not step:
            raise ValueError("step must be a non-empty list")
        for prev, nxt in zip(step, step[1:]):
            if nxt <= prev:
                raise ValueError("schedule steps must strictly increase")
        if step[0] < 1:
            raise ValueError("schedule step must be >= 1")
        if factor > 1.0:
            raise ValueError("factor must be <= 1 so the lr decays")
        self.step, self.factor = step, factor
        self.cur_step_ind, self.count = 0, 0

    def __call__(self, num_update):
        while self.cur_step_ind < len(self.step) \
                and num_update > self.step[self.cur_step_ind]:
            self.count = self.step[self.cur_step_ind]
            self.cur_step_ind += 1
            self.base_lr = self.base_lr * self.factor
            logging.info("Update[%d]: Change learning rate to %0.5e"
                         % (num_update, self.base_lr))
        return self.base_lr


class PolyScheduler(LRScheduler):
    """Polynomial decay from base_lr to final_lr over max_update steps."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0):
        super().__init__(base_lr)
        self.max_update = max_update
        self.power = pwr
        self.final_lr = final_lr
        self.base_lr_orig = base_lr

    def __call__(self, num_update):
        if num_update <= self.max_update:
            frac = 1.0 - float(num_update) / self.max_update
            span = self.base_lr_orig - self.final_lr
            self.base_lr = self.final_lr + span * frac ** self.power
        return self.base_lr


class CosineScheduler(LRScheduler):
    """Half-cosine decay from base_lr to final_lr over max_update steps."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0):
        super().__init__(base_lr)
        self.max_update = max_update
        self.final_lr = final_lr
        self.base_lr_orig = base_lr

    def __call__(self, num_update):
        if num_update <= self.max_update:
            phase = math.pi * num_update / self.max_update
            span = self.base_lr_orig - self.final_lr
            self.base_lr = self.final_lr + span * (1 + math.cos(phase)) / 2
        return self.base_lr
