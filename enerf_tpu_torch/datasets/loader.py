"""Data loader factory; counterpart of ``enerf_tpu/datasets/loader.py``
(reference lib/datasets/make_dataset.py:17-104 + samplers.py).

- ``ViewCountSampler``: every batch carries one source-view count drawn
  from ``input_views_num`` / ``input_views_prob``; the arrays stay padded
  to S_max, so the device shapes never change.
- an iteration cap per epoch (IterationBasedBatchSampler);
- per-host sharding (DistributedSampler's stride);
- thread-pool prefetch in place of torch DataLoader workers (the decoders
  and ``native`` release the GIL), worker errors raised in the consumer.

The config names a dataset by the JAX package's module path
(``enerf_tpu.datasets.<name>``); ``make_dataset`` maps its last component
to the port's module by the table ``DATASETS``, as ``factory.py`` maps
networks and evaluators.
"""

from __future__ import annotations

import importlib
import queue
import threading
import time
from typing import Dict, Iterator, List, Mapping, Optional

import numpy as np
import torch

from enerf_tpu_torch import native
from enerf_tpu_torch.config import Config

# the port's dataset modules, each holding a ``Dataset``
DATASETS = {
    "dtu": "enerf_tpu_torch.datasets.dtu",
    "nerf_synthetic": "enerf_tpu_torch.datasets.nerf_synthetic",
    "llff": "enerf_tpu_torch.datasets.llff",
    "synthetic": "enerf_tpu_torch.datasets.synthetic",
    "zjumocap": "enerf_tpu_torch.datasets.zjumocap",
    "zjumocap_interactive": "enerf_tpu_torch.datasets.zjumocap_interactive",
    "enerf_outdoor": "enerf_tpu_torch.datasets.enerf_outdoor",
    "enerf_outdoor_path": "enerf_tpu_torch.datasets.enerf_outdoor_path",
}

# keys kept on the host (eval-only ground truth; 'meta' mirrors the
# reference's to_cuda skip, data_utils.py:564-581). tar_ext / tar_ixt ARE
# device inputs.
_HOST_ONLY = ("tar_img", "tar_dpt", "tar_mask")


def is_host_only(key: str) -> bool:
    return key == "meta" or any(key == p or key.startswith(p + "_")
                                for p in _HOST_ONLY)


def device_batch(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    """The device inputs of a batch dict of numpy arrays / tensors: every
    array but the host-only keys (``is_host_only``), as float32 tensors on
    ``device``; non-array entries are dropped."""
    out = {}
    for k, v in batch.items():
        if is_host_only(k):
            continue
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        if isinstance(v, torch.Tensor):
            out[k] = v.to(device=device, dtype=torch.float32).contiguous()
    return out


def dataset_module(module_name: str) -> str:
    """The port's module for a config's dataset module path; raises
    ``ValueError`` for a dataset the port has not ported."""
    name = module_name.rsplit(".", 1)[-1]
    if name not in DATASETS:
        raise ValueError(
            f"dataset module {module_name!r} is not ported to "
            f"enerf_tpu_torch yet (ported: {sorted(DATASETS)})")
    return DATASETS[name]


def make_dataset(cfg: Config, split: str, device=None):
    """The ``Dataset`` of the module the config names for ``split``
    (reference make_dataset.py:17-30). ``device`` is the interactive
    dataset's, whose ray grid lives on the model's device; no other
    dataset takes one."""
    ds_cfg = cfg.train_dataset if split == "train" else cfg.test_dataset
    module_name = (cfg.train_dataset_module if split == "train"
                   else cfg.test_dataset_module)
    module_path = dataset_module(module_name)
    module = importlib.import_module(module_path)
    if module_path == DATASETS["zjumocap_interactive"]:
        return module.Dataset(cfg, ds_cfg, device=device)
    if device is not None:
        raise ValueError(f"make_dataset: {module_path} takes no device")
    return module.Dataset(cfg, ds_cfg)


class ViewCountSampler:
    """Yields (index, n_views) tuples; n_views sampled per batch."""

    def __init__(self, n: int, views: List[int], probs: List[float],
                 shuffle: bool, seed: int = 0):
        self.n = n
        self.views = list(views)
        self.probs = list(probs)
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        rng = np.random.RandomState(self.seed + self.epoch)
        order = rng.permutation(self.n) if self.shuffle else np.arange(self.n)
        for idx in order:
            nv = rng.choice(self.views, p=self.probs) if len(self.views) > 1 \
                else self.views[0]
            yield int(idx), int(nv)

    def __len__(self):
        return self.n


class _LockedRng:
    """Mutex around a numpy RandomState so parallel __getitem__ calls stay
    safe (RandomState is not thread-safe). Like torch DataLoader workers,
    draw *order* under concurrency is nondeterministic."""

    def __init__(self, rng):
        self._rng = rng
        self._lock = threading.Lock()

    def __getattr__(self, name):
        fn = getattr(self._rng, name)
        if not callable(fn):
            return fn

        def locked(*a, **kw):
            with self._lock:
                return fn(*a, **kw)
        return locked


class DataLoader:
    """Batched iterator with pipelined thread prefetch (the torch
    DataLoader-workers equivalent). All samples of a batch share the same
    n_views; per-host sharding slices the index stream. ``host_ms`` holds,
    for each batch of the last iteration, the host time its samples and
    collation took in a worker."""

    def __init__(self, dataset, batch_size: int, sampler: ViewCountSampler,
                 max_iter: Optional[int] = None, num_workers: int = 2,
                 process_index: int = 0, process_count: int = 1,
                 drop_last: bool = True):
        if num_workers > 1 and hasattr(dataset, "rng") \
                and not isinstance(dataset.rng, _LockedRng):
            dataset.rng = _LockedRng(dataset.rng)
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.max_iter = max_iter
        self.num_workers = max(num_workers, 1)
        self.process_index = process_index
        self.process_count = process_count
        self.drop_last = drop_last
        self.host_ms: List[float] = []

    def _batches(self) -> Iterator[List]:
        buf: List = []
        nv_cur: Optional[int] = None
        count = 0
        while True:  # cycle epochs to honor max_iter (IterationBased)
            for i, (idx, nv) in enumerate(self.sampler):
                if i % self.process_count != self.process_index:
                    continue  # host shard (DistributedSampler stride)
                if nv_cur is None:
                    nv_cur = nv
                buf.append((idx, nv_cur))
                if len(buf) == self.batch_size:
                    yield buf
                    count += 1
                    if self.max_iter is not None and count >= self.max_iter:
                        return
                    buf, nv_cur = [], None
            if self.max_iter is None:
                if buf and not self.drop_last:
                    yield buf
                return
            self.sampler.set_epoch(self.sampler.epoch + 1)

    @staticmethod
    def _collate(samples: List[Dict]) -> Dict:
        out = {}
        for k in samples[0]:
            if k == "meta":
                out["meta"] = {kk: [s["meta"][kk] for s in samples]
                               for kk in samples[0]["meta"]}
            else:
                out[k] = native.collate([s[k] for s in samples])
        return out

    def _load_batch(self, batch_idx) -> tuple:
        t0 = time.perf_counter()
        batch = self._collate([self.dataset[im] for im in batch_idx])
        return batch, 1e3 * (time.perf_counter() - t0)

    def __iter__(self):
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        q: "queue.Queue" = queue.Queue(maxsize=self.num_workers * 2)
        stop = object()
        self.host_ms = []

        def produce():
            # pipeline whole batches across the pool, yielding in order
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    pending = deque()
                    for batch_idx in self._batches():
                        pending.append(pool.submit(self._load_batch,
                                                   batch_idx))
                        if len(pending) >= self.num_workers:
                            q.put(pending.popleft().result())
                    while pending:
                        q.put(pending.popleft().result())
            except Exception as e:  # surface loader errors to the consumer
                q.put(e)
            finally:
                q.put(stop)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, Exception):
                raise item
            batch, ms = item
            self.host_ms.append(ms)
            yield batch

    def __len__(self):
        if self.max_iter is not None:
            return self.max_iter
        return len(self.sampler) // (self.batch_size * self.process_count)


def make_data_loader(cfg: Config, split: str,
                     max_iter: Optional[int] = None,
                     process_index: int = 0, process_count: int = 1
                     ) -> DataLoader:
    """The loader of ``split``: ``cfg.ep_iter`` batches an epoch in
    training, one pass over the test set otherwise.

    ``process_index`` / ``process_count``: the rank and world size of a
    data-parallel run. Every rank walks the same epoch-seeded permutation
    and keeps every ``process_count``-th sample from ``process_index`` on
    (the reference's DistributedSampler stride), so the ranks' samples are
    disjoint; each rank's batch takes the view count drawn for its own
    first sample, so ranks may train one step on different view counts,
    as the JAX package's hosts do (``enerf_tpu/datasets/loader.py:127``)."""
    dataset = make_dataset(cfg, split)
    is_train = split == "train"
    ds_cfg = cfg.train_dataset if is_train else cfg.test_dataset
    if is_train:
        views = list(cfg.train.input_views_num)
        probs = list(cfg.train.input_views_prob)
        if max_iter is None:
            max_iter = cfg.ep_iter
    else:
        views = [cfg.enerf.test_input_views]
        probs = [1.0]
    sampler = ViewCountSampler(len(dataset), views, probs, shuffle=is_train)
    return DataLoader(dataset, ds_cfg.batch_size, sampler, max_iter=max_iter,
                      num_workers=cfg.train.num_workers,
                      process_index=process_index,
                      process_count=process_count,
                      drop_last=is_train)
