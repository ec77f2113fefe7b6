"""
Composable learning-rate schedules: the port's own copy of bonito_tpu's
(``bonito_tpu/schedule.py``, upstream bonito's ``bonito/schedule.py``).

Schedule factories return a builder taking (steps_per_epoch, epochs,
last_epoch) and producing a plain ``step -> lr multiplier`` callable; the
train step multiplies the optimiser's whole update by it
(``training.train_step``).
"""

import math

import numpy as np


# -- primitive schedules over normalised progress t in [0, 1] ----------------

def const_schedule(y):
    return lambda t: y


def linear_schedule(y0, y1):
    return lambda t: y0 + (y1 - y0) * t


def cosine_decay_schedule(y0, y1):
    return lambda t: y1 + 0.5 * (y0 - y1) * (np.cos(t * np.pi) + 1.0)


def inverse_sqrt_decay_schedule(scale):
    return lambda t: 1.0 / math.sqrt(1 + scale * t)


def piecewise_schedule(knots, funcs):
    def f(t):
        i = int(np.searchsorted(knots, t))
        t0 = 0.0 if i == 0 else knots[i - 1]
        t1 = 1.0 if i == len(knots) else knots[i]
        return funcs[i]((t - t0) / (t1 - t0))
    return f


def func_scheduler(func, total_steps, warmup_steps=None, warmup_ratio=0.1,
                   start_step=0):
    """step -> multiplier, with optional linear warmup spliced in front."""
    if warmup_steps:
        y0 = func(0.0)
        func = piecewise_schedule(
            [warmup_steps / total_steps],
            [linear_schedule(warmup_ratio * y0, y0), func],
        )
    return lambda step: float(func(min((step + start_step) / total_steps, 1.0)))


# -- named schedules selectable from config [lr_scheduler] -------------------

def linear_warmup_cosine_decay(end_ratio=0.01, warmup_steps=500, **kwargs):
    def build(steps_per_epoch, epochs, last_epoch=0):
        return func_scheduler(
            func=cosine_decay_schedule(1.0, end_ratio),
            total_steps=epochs * steps_per_epoch,
            warmup_steps=warmup_steps,
            start_step=last_epoch * steps_per_epoch,
        )
    return build


def linear_warmup_const_inverse_sqrt_decay(
    warmup_steps=1000, decay_start_epoch=10, decay_scale=1.0,
    linear_cooldown_n_epochs=0, linear_cooldown_end_ratio=0.0, **kwargs,
):
    def build(steps_per_epoch, epochs, last_epoch=0):
        start_step = steps_per_epoch * last_epoch
        total_steps = steps_per_epoch * epochs
        # short runs: the decay phase may not exist (epochs <=
        # decay_start + cooldown). Clamp the knots to stay sorted and
        # the decay span non-negative — unsorted knots mis-route
        # searchsorted and a negative span takes sqrt of a negative.
        eff_decay_start = min(decay_start_epoch, epochs)
        eff_cooldown = min(linear_cooldown_n_epochs,
                           max(epochs - eff_decay_start, 0))
        n_decay_epochs = max(epochs - eff_decay_start - eff_cooldown, 0)
        decay = (inverse_sqrt_decay_schedule(decay_scale * n_decay_epochs)
                 if n_decay_epochs > 0 else const_schedule(1.0))
        knots = [
            max(warmup_steps, 1) / total_steps,
            eff_decay_start / epochs,
            (epochs - eff_cooldown) / epochs,
        ]
        # clamp against the already-clamped predecessor: reading the
        # original list could leave the knots unsorted (e.g. raw
        # [0.909, 0.1, 0.2] -> [0.909, 0.909, 0.2]), mis-routing
        # piecewise_schedule's searchsorted
        clamped = []
        for k in knots:
            lo = clamped[-1] if clamped else 0.0
            clamped.append(min(max(k, lo), 1.0))
        knots = clamped
        func = piecewise_schedule(
            knots,
            [
                linear_schedule(0.0, 1.0),
                const_schedule(1.0),
                decay,
                linear_schedule(decay(1.0), linear_cooldown_end_ratio),
            ],
        )
        return lambda step: float(func(min((step + start_step) / total_steps, 1.0)))
    return build


def linear_cooldown(end_ratio=0.0, **kwargs):
    def build(steps_per_epoch, epochs, last_epoch=0):
        return func_scheduler(
            func=linear_schedule(1.0, end_ratio),
            total_steps=epochs * steps_per_epoch,
        )
    return build
