"""The host-side step breakdown of a train epoch (the JAX package's
utils/profiling.py StepTimer): the wall time spent waiting for the next
batch against the wall time of the step that uses it."""

import time


class StepTimer:
    """Accumulates data-wait and step wall time over an epoch. Call
    `data_ready` when a batch is in hand and `step_done` after its step;
    `restart` after other work between steps (a checkpoint write, an
    eval), which then counts as neither."""

    def __init__(self):
        self.data_time = 0.0
        self.step_time = 0.0
        self.steps = 0
        self._mark = time.perf_counter()

    def data_ready(self):
        now = time.perf_counter()
        self.data_time += now - self._mark
        self._mark = now

    def step_done(self):
        now = time.perf_counter()
        self.step_time += now - self._mark
        self._mark = now
        self.steps += 1

    def restart(self):
        self._mark = time.perf_counter()

    def summary(self):
        n = max(self.steps, 1)
        return {
            'data_ms_per_step': 1000.0 * self.data_time / n,
            'step_ms_per_step': 1000.0 * self.step_time / n,
            'data_fraction': self.data_time /
            max(self.data_time + self.step_time, 1e-9),
        }
