"""Metric names, the reference-style metrics table and the rolling loss
mean (reference: utils/logging.py:10-83,139-167, model_wrapper.py:792-918)."""

import os

import torch

METRIC_NAMES = ['abs_rel', 'sqr_rel', 'rmse', 'rmse_log', 'a1', 'a2', 'a3']


def pcolor(text, color='cyan', attrs=None):
    codes = {'red': 31, 'green': 32, 'yellow': 33, 'blue': 34,
             'magenta': 35, 'cyan': 36, 'white': 37}
    bold = '1;' if attrs and 'bold' in attrs else ''
    if os.environ.get('NO_COLOR'):
        return text
    return '\033[{}{}m{}\033[0m'.format(bold, codes.get(color, 36), text)


def print_metrics_table(title, metrics_by_mode):
    """metrics_by_mode: {mode_name: [7 floats]}."""
    bar = '*' * 92
    hdr = '| {:<18} | ' + ' | '.join('{:>8}' for _ in METRIC_NAMES) + ' |'
    row = '| {:<18} | ' + ' | '.join('{:>8.3f}' for _ in METRIC_NAMES) + ' |'
    lines = [bar, pcolor('### {}'.format(title), 'cyan', ['bold']),
             hdr.format('mode', *METRIC_NAMES)]
    for mode, vals in metrics_by_mode.items():
        lines.append(row.format(mode, *[float(v) for v in vals]))
    lines.append(bar)
    print('\n'.join(lines))


class AvgMeter:
    """Rolling mean of the last `n_max` values of a scalar stream (the
    reference's AvgMeter(50) on the train loss). The values are kept as
    they come, device tensors too; `get` reads their mean with one
    transfer."""

    def __init__(self, n_max=100):
        self.n_max = n_max
        self.values = []

    def __call__(self, value):
        self.values.append(value)
        if len(self.values) > self.n_max:
            self.values.pop(0)

    def get(self):
        if not self.values:
            return 0.0
        return float(torch.stack([torch.as_tensor(v, dtype=torch.float32)
                                  for v in self.values]).mean())
