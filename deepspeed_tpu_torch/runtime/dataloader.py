"""Data loading (copy of ``deepspeed_tpu/runtime/dataloader.py``).

A host-side batched iterator producing dict batches of numpy arrays, which
the engine moves to its device. With data parallelism each process would
read only its rank's slice; the port trains on one device (rank 0 of 1).
"""

import numpy as np

from ..utils.logging import logger


class RepeatingLoader:
    """Reference ``runtime/dataloader.py`` RepeatingLoader: wrap an iterator to
    restart from the beginning when exhausted."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


class DeepSpeedDataLoader:
    """Batched loader over an indexable dataset of dict samples (or (x, y) tuples).

    process_shard: with multi-host data parallelism each process reads only its
    dp-rank slice (the reference's DistributedSampler); rank/num_shards come from
    the engine.
    """

    def __init__(self, dataset, batch_size, shuffle=False, seed=1234, drop_last=True,
                 collate_fn=None, rank=0, num_shards=1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.collate_fn = collate_fn or default_collate
        self.rank = rank
        self.num_shards = num_shards
        self.epoch = 0
        if len(dataset) < batch_size * num_shards:
            logger.warning(
                f"Dataset of {len(dataset)} samples smaller than global batch "
                f"{batch_size * num_shards}"
            )

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(indices)
        # contiguous shard per dp rank
        shard = indices[self.rank::self.num_shards]
        n_batches = len(self)
        for b in range(n_batches):
            idx = shard[b * self.batch_size:(b + 1) * self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                return
            yield self.collate_fn([self.dataset[int(i)] for i in idx])


def default_collate(samples):
    """Stack dict-of-array samples (or (x, y) tuples) into a dict batch."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in first}
    if isinstance(first, (tuple, list)) and len(first) == 2:
        xs = np.stack([np.asarray(s[0]) for s in samples])
        ys = np.stack([np.asarray(s[1]) for s in samples])
        return {"x": xs, "y": ys}
    return {"x": np.stack([np.asarray(s) for s in samples])}
