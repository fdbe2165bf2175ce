"""Synthetic data and the classification loss
(``pytorch_ps_mpi_tpu/data.py``).

``synthetic_images``, ``synthetic_mlm`` and ``synthetic_lm`` (with its
Markov chain, ``markov_table``/``sample_markov``) draw from the same
numpy ``RandomState`` streams as the JAX package's generators, so both
packages see the same batches for the same seed; only the final copy to
a tensor differs. ``prefetch`` builds batches on a host thread ahead of
the step.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pytorch_ps_mpi_tpu_torch.mesh import Device, resolve_device

SHAPES = {
    "mnist": ((28, 28, 1), 10),
    "cifar10": ((32, 32, 3), 10),
    "imagenet": ((224, 224, 3), 1000),
}


def synthetic_images(
    name: str, batch: int, seed: int = 0, *, device: Device = "cuda",
) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Endless iterator of ``(images[B, H, W, C] float32, labels[B]
    int64)`` with a learnable class signal (per-class mean offsets)."""
    dev = resolve_device(device)
    shape, classes = SHAPES[name]
    rng = np.random.RandomState(seed)
    class_means = rng.randn(classes, *shape).astype(np.float32) * 0.5
    while True:
        labels = rng.randint(0, classes, size=(batch,))
        x = rng.randn(batch, *shape).astype(np.float32) + class_means[labels]
        yield (torch.from_numpy(x).to(dev),
               torch.from_numpy(labels.astype(np.int64)).to(dev))


def synthetic_mlm(
    batch: int, seq_len: int, vocab_size: int, mask_rate: float = 0.15,
    mask_token: int = 0, seed: int = 0, *, device: Device = "cuda",
) -> Iterator[Dict[str, torch.Tensor]]:
    """Endless iterator of MLM batches ``{"tokens", "targets"}`` (int64
    ``[B, L]``) and ``"mask"`` (bool ``[B, L]``)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    while True:
        targets = rng.randint(1, vocab_size, size=(batch, seq_len))
        mask = rng.rand(batch, seq_len) < mask_rate
        tokens = np.where(mask, mask_token, targets)
        yield {"tokens": torch.from_numpy(tokens.astype(np.int64)).to(dev),
               "targets": torch.from_numpy(targets.astype(np.int64)).to(dev),
               "mask": torch.from_numpy(mask).to(dev)}


def synthetic_lm(
    batch: int, seq_len: int, vocab_size: int, seed: int = 0,
    order: int = 1, table_seed: Optional[int] = None, *,
    device: Device = "cuda",
) -> Iterator[Dict[str, torch.Tensor]]:
    """Endless iterator of causal-LM batches ``{"tokens"}`` (int64 ``[B,
    L]``) sampled from a fixed random Markov chain, so next-token loss has
    signal below the uniform floor. ``order=1`` is a bigram chain; higher
    orders hash the last tokens into the state. ``table_seed`` fixes the
    chain apart from the sampling stream, so ranks that sample with
    different seeds still sample one language."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    cum = markov_table(vocab_size, seed if table_seed is None else table_seed)
    while True:
        toks = sample_markov(cum, batch, seq_len, rng, order=order)
        yield {"tokens": torch.from_numpy(toks).to(dev)}


def markov_table(vocab_size: int, seed: int = 0) -> np.ndarray:
    """The chain behind :func:`synthetic_lm` as a cumulative table
    ``[n_ctx, vocab]``: built once, sampled many times."""
    rng = np.random.RandomState(seed)
    n_ctx = min(64, vocab_size)  # contexts hash into this many states
    table = rng.dirichlet(np.ones(vocab_size) * 0.05, size=n_ctx)
    return np.cumsum(table, axis=-1)


def sample_markov(cum: np.ndarray, batch: int, seq_len: int,
                  rng: np.random.RandomState, order: int = 1) -> np.ndarray:
    """One int64 ``[batch, seq_len]`` token batch from a
    :func:`markov_table`."""
    n_ctx, vocab_size = cum.shape
    toks = np.zeros((batch, seq_len), np.int64)
    toks[:, 0] = rng.randint(0, vocab_size, size=batch)
    state = toks[:, 0] % n_ctx
    for t in range(1, seq_len):
        u = rng.rand(batch, 1)
        toks[:, t] = (u < cum[state]).argmax(axis=-1)
        if order == 1:
            state = toks[:, t] % n_ctx
        else:
            state = (state * 31 + toks[:, t]) % n_ctx
    return toks


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Batches of ``it`` built on a background thread, up to ``depth``
    ahead, so batch construction overlaps the step. Exceptions in ``it``
    reach the consumer; ``StopIteration`` ends the stream. Closing the
    consumer stops the thread (it checks a stop event around its bounded
    puts) and waits up to 5 s for it to finish the batch it is building:
    a thread cut off inside a PyTorch call at interpreter exit aborts the
    process. The thread is a daemon, so a source that never returns does
    not hold the interpreter."""
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    end = object()

    def offer(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def pump():
        try:
            for item in it:
                if not offer((True, item)):
                    return
        except BaseException as e:  # noqa: BLE001 -- handed to the consumer
            offer((False, e))
            return
        offer((True, end))

    thread = threading.Thread(target=pump, daemon=True)
    thread.start()
    try:
        while True:
            ok, item = q.get()
            if not ok:
                raise item
            if item is end:
                return
            yield item
    finally:
        stop.set()
        thread.join(timeout=5.0)


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over the batch."""
    return F.cross_entropy(logits.to(torch.float32), labels.long())
