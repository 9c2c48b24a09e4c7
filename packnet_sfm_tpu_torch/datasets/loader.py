"""
Host-side data loader: batched, prefetched, one shard (the JAX package's
datasets/loader.py, before its multi-process sharding, which waits for the
DDP slice), the move of a collated batch onto the device, and
`prefetch_to_device`, which keeps batches on the card ahead of the step
(the JAX package's parallel/mesh.py prefetch_to_device).

Samples are decoded by a thread pool (Pillow and numpy release the GIL),
collated into stacked numpy arrays, and a background thread keeps
`prefetch` batches ahead of the consumer. The shuffle is keyed by
(seed, epoch), and a `batch_augment` (mixup, cutmix) draws each batch's
augmentation from np.random.RandomState([seed, epoch, batch index]), so
(epoch, batches consumed) resumes an epoch exactly. The JAX loader's
collate draws mixup and cutmix from one RandomState(seed), whose position
no checkpoint keeps.

Unlike the JAX loader, whose producer thread dies on a sample that fails to
load and leaves the consumer waiting, a failed batch raises its error from
`next()` and the iteration goes on with the next batch.
"""

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# keys that stay on the host (the JAX trainer's _host_prepare)
HOST_KEYS = ('idx', 'filename', 'rgb_path', 'sensor_name', 'splitname',
             'dataset_idx')


def default_collate(samples):
    """Stack a list of sample dicts into a batch dict of arrays."""
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        v0 = vals[0]
        if isinstance(v0, dict):
            out[key] = default_collate(vals)
        elif isinstance(v0, (list, tuple)):
            out[key] = [np.stack([v[i] for v in vals])
                        for i in range(len(v0))]
        elif isinstance(v0, np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(v0, (int, float, np.integer, np.floating)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals  # strings and paths ride along
    return out


def _to_device(value, device, pin=False):
    """`value` (arrays and tensors, in dicts and lists too) on `device`.
    With `pin`, each array is first copied into page-locked host memory
    and moved with a non-blocking copy on the current stream."""
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(value)
    if isinstance(value, torch.Tensor):
        if pin:
            return value.pin_memory().to(device, non_blocking=True)
        return value.to(device)
    if isinstance(value, dict):
        return {k: _to_device(v, device, pin) for k, v in value.items()}
    if isinstance(value, list):
        return [_to_device(v, device, pin) for v in value]
    return value


def _tensors(value):
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, list):
        for v in value:
            yield from _tensors(v)


def fold_cameras(value):
    """A multi-camera batch with its camera axis folded into the batch axis:
    every array or tensor of 3 or more dimensions, in dicts and lists too,
    [B, N, ...] -> [B*N, ...] (the JAX package's fold_multicam_batch;
    reference models/model_utils.py:68-94)."""
    if isinstance(value, dict):
        return {k: fold_cameras(v) for k, v in value.items()}
    if isinstance(value, list):
        return [fold_cameras(v) for v in value]
    if getattr(value, 'ndim', 0) >= 3:
        return value.reshape((-1,) + tuple(value.shape[2:]))
    return value


def to_device_batch(batch, device):
    """A collated batch without its host-only keys, its numpy arrays (in
    dicts and lists too) as tensors on `device`. Tensors move to `device`;
    strings stay. A multi-camera batch (rgb [B,N,H,W,3], DGP) has its
    cameras folded into the batch axis (`fold_cameras`), as the JAX
    trainer's _host_prepare does."""
    batch = {k: v for k, v in batch.items() if k not in HOST_KEYS}
    rgb = batch.get('rgb')
    if rgb is not None and rgb.ndim == 5:
        batch = fold_cameras(batch)
    return {k: _to_device(v, device) for k, v in batch.items()}


def prefetch_to_device(iterator, device, size=2):
    """Yield the batches of `iterator` (collated host batches) on `device`
    without their host-only keys, keeping `size` of them moved ahead of the
    consumer. On the card each batch goes through page-locked host memory
    and non-blocking copies on a side CUDA stream; the batch handed over
    is ready for the consumer's stream, which waits on the copies' event,
    and its tensors are recorded on that stream so that their memory is
    not reused before its work on them is done. On the CPU the batches
    move as `to_device_batch` moves them."""
    device = torch.device(device)
    if device.type != 'cuda':
        for batch in iterator:
            yield to_device_batch(batch, device)
        return
    side = torch.cuda.Stream(device)
    ahead = collections.deque()

    def put(batch):
        batch = to_device_batch(batch, 'cpu')
        with torch.cuda.stream(side):
            moved = _to_device(batch, device, pin=True)
            done = torch.cuda.Event()
            done.record(side)
        return moved, done

    def ready(item):
        moved, done = item
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for t in _tensors(moved):
            t.record_stream(consumer)
        return moved

    for batch in iterator:
        ahead.append(put(batch))
        if len(ahead) >= size:
            yield ready(ahead.popleft())
    while ahead:
        yield ready(ahead.popleft())


class _Failure:
    def __init__(self, error):
        self.error = error


_END = object()


class _BatchIterator:
    """Batches from a producer thread; a batch that failed to load raises
    its error from __next__, and the next call goes on with the next one."""

    def __init__(self, loader, indices, start, n_batches):
        self._loader = loader
        epoch = loader.epoch
        self._queue = queue.Queue(maxsize=loader.prefetch)
        self._done = False
        bs = loader.batch_size

        def produce():
            with ThreadPoolExecutor(loader.num_workers) as pool:
                for b in range(start, n_batches):
                    chunk = indices[b * bs:(b + 1) * bs]
                    try:
                        item = loader.collate_fn(
                            list(pool.map(loader.dataset.__getitem__, chunk)))
                        if loader.batch_augment is not None:
                            item = loader.batch_augment(
                                item, np.random.RandomState(
                                    [loader.seed, epoch, b]))
                    except Exception as e:  # noqa: BLE001 — handed on
                        item = _Failure(e)
                    self._queue.put(item)
            self._queue.put(_END)

        threading.Thread(target=produce, daemon=True).start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._queue.get()
        if item is _END:
            self._done = True
            raise StopIteration
        self._loader._consumed += 1
        if isinstance(item, _Failure):
            raise item.error
        return item


class DataLoader:
    """Batches of `dataset` (see the module note). `batch_augment`, when
    given, is called as batch_augment(batch, rng) on each collated batch,
    with rng the np.random.RandomState of (seed, epoch, batch index)."""

    def __init__(self, dataset, batch_size, shuffle=False, seed=42,
                 num_workers=4, prefetch=2, drop_last=True, collate_fn=None,
                 batch_augment=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.collate_fn = collate_fn or default_collate
        self.batch_augment = batch_augment
        self.epoch = 0
        self._consumed = 0
        self._skip = 0

    def set_epoch(self, epoch):
        """Reshuffle for `epoch` (DistributedSampler.set_epoch), and pass
        the epoch on to a dataset that keys its augmentation by it."""
        self.epoch = epoch
        self._consumed = 0
        if hasattr(self.dataset, 'set_epoch'):
            self.dataset.set_epoch(epoch)

    @property
    def skip(self):
        """The batches the next iteration skips (a loaded position)."""
        return self._skip

    def state_dict(self):
        """The position for an exact resume: (epoch, batches consumed)."""
        return {'epoch': self.epoch, 'batches_consumed': self._consumed}

    def load_state_dict(self, state):
        """Resume at `state`: its epoch, and the next iteration skips the
        batches that were consumed."""
        self.set_epoch(int(state.get('epoch', 0)))
        self._skip = int(state.get('batches_consumed', 0))

    def _indices(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def __iter__(self):
        start, self._skip = self._skip, 0
        self._consumed = start
        return _BatchIterator(self, self._indices(), start, len(self))
