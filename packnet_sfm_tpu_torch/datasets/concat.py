"""Dataset concatenation with a repeat count per dataset (the JAX package's
datasets/concat.py; reference: model_wrapper.py:1112-1125)."""

import bisect


class ConcatDataset:
    def __init__(self, datasets, repeats=None):
        repeats = repeats or [1] * len(datasets)
        self.datasets = datasets
        self.repeats = [max(1, int(r)) for r in repeats]
        self.cum = []
        total = 0
        for ds, r in zip(self.datasets, self.repeats):
            total += len(ds) * r
            self.cum.append(total)

    def set_epoch(self, epoch):
        for ds in self.datasets:
            if hasattr(ds, 'set_epoch'):
                ds.set_epoch(epoch)

    def __len__(self):
        return self.cum[-1] if self.cum else 0

    def __getitem__(self, idx):
        di = bisect.bisect_right(self.cum, idx)
        base = self.cum[di - 1] if di > 0 else 0
        local = (idx - base) % len(self.datasets[di])
        return self.datasets[di][local]
