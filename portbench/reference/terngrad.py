"""TernGrad (Wen et al. 2017) at one worker: each element of a unit (a
leaf, or a flat bucket of leaves) becomes ``s * sign(g) * b`` with ``s =
max(max|g|, 1e-12)`` over the unit and ``b ~ Bernoulli(|g| / s)``.

The Bernoulli draws are worked out again from the seed the optimizer
was given, in the order and sizes in which the optimizer draws them:
its ``torch.Generator`` on the gradients' device is seeded ``seed *
1_000_003 + rank``, and the units are drawn in bucket (or leaf) order,
each whole below ``scan_threshold`` elements and ``scan_block`` elements
at a time from it. A unit whose size divides by 512 (with ``use_pallas``)
draws uint32 bits as int32 and keeps an element where ``(bits >> 8) &
0xFFFFFF < |g| * (2**24 / s)``; any other unit draws float32 uniforms
and keeps where ``u < |g| / s``.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench.reference import bucketing


class Reference:
    def __init__(self, args: dict, bucket_mb: float, seed: int, device,
                 rank: int = 0):
        self.use_pallas = bool(args.get("use_pallas", False))
        self.scan_block = int(args.get("scan_block", 1 << 20))
        self.scan_threshold = int(args.get("scan_threshold", 0)) or \
            4 * self.scan_block
        self.bucket_mb = float(bucket_mb)
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed * 1_000_003 + rank)

    def _bits_layout(self, n: int) -> bool:
        if not (self.use_pallas and n > 0 and n % 512 == 0):
            return False
        return n < self.scan_threshold or self.scan_block % 512 == 0

    def _draw(self, size: int, bits: bool, device) -> torch.Tensor:
        if bits:
            return torch.randint(-2**31, 2**31, (size,), dtype=torch.int32,
                                 device=device, generator=self.gen)
        return torch.rand(size, generator=self.gen, device=device)

    def ternarize(self, g: torch.Tensor) -> torch.Tensor:
        """The decoded ternary gradient of one flat float32 unit."""
        n = g.numel()
        bits = self._bits_layout(n)
        s = torch.clamp(g.abs().amax(), min=1e-12)
        sizes: List[int] = ([n] if n < self.scan_threshold else
                            [min(self.scan_block, n - a)
                             for a in range(0, n, self.scan_block)])
        draws = torch.cat([self._draw(m, bits, g.device) for m in sizes])
        if bits:
            p24 = g.abs() * (torch.full((), 16777216.0, device=g.device) / s)
            keep = ((draws >> 8) & 0xFFFFFF).to(torch.float32) < p24
        else:
            keep = draws < g.abs() / s
        value = torch.where(g >= 0, s, -s)
        return torch.where(keep, value, torch.zeros_like(g))

    def aggregate(self, grads: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        if self.bucket_mb <= 0:
            return {k: self.ternarize(g.reshape(-1)).reshape(g.shape)
                    for k, g in grads.items()}
        out = {}
        for names in bucketing.plan(grads, self.bucket_mb):
            flat = self.ternarize(bucketing.flatten(grads, names))
            out.update(bucketing.unflatten(flat, grads, names))
        return {k: out[k] for k in grads}
