"""YCSB's core-workload key chooser and a closed loop of batched clients.

The one generator every traffic file of this folder names (``"generator":
"ycsb"``).  A traffic file holds only parameters; this module turns them and
a seed into requests.

Keys come from YCSB's ``ScrambledZipfianGenerator`` (Cooper et al., SoCC
2010; ``site.ycsb.generator``), copied here operation for operation:

* ``ZipfianGenerator(0, ITEM_COUNT, 0.99, ZETAN)`` draws a rank over YCSB's
  fixed item space of 10^10 + 1 items (Gray et al., SIGMOD 1994), at the
  one constant the chooser uses (``USED_ZIPFIAN_CONSTANT``, for which
  ``ZETAN`` is precomputed; a mix cannot set another): with
  ``u`` uniform in [0, 1), rank 0 when ``u * zetan < 1``, rank 1 when it is
  below ``1 + 0.5^theta``, else ``(long)(items * (eta * u - eta + 1)^alpha)``;
* ``Utils.fnvhash64`` (64-bit FNV-1a over the rank's eight bytes, low byte
  first, then ``Math.abs``) scrambles the rank;
* the record index is that hash modulo the record count (Java's ``%``).

The ranks are drawn on the device with a ``torch.Generator`` seeded from
``--seed``, in float64 as Java's ``nextDouble``; the same code runs on the
CPU in the tests.

The loop is closed, as YCSB's is: ``clients`` clients each submit one
request a round, a batch of ``request_keys`` keys (a multi-get, or a
multi-put of new values for existing keys), and every request of a round
is acknowledged by the round's one ``drain()``.  Submission ``seq`` of the
run (0, 1, 2, ...) is the ``seq % clients``-th submission of round ``seq //
clients``.

The pool.  Set-up draws ``pool_keys`` keys once.  A pass over the pool is
``pool_keys / request_keys`` requests; request ``j`` of pass ``p`` reads the
``request_keys`` pool entries from ``j * request_keys + offset[p]``
(circularly), with ``offset[0] = 0`` and the later passes' offsets drawn
from the seed, so no two requests of a run are the same batch.  Whether a
request reads or writes is ``kinds[j]``: exactly ``round(pool_requests *
update_proportion)`` writes a pass, in an order drawn from the seed, so
every seed offers the same work in another order.  A write's values are
``write_base ^ (seq + 1)``: every write of a run writes values no earlier
write wrote to those lanes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

# ScrambledZipfianGenerator's constants (YCSB 0.17.0).
ITEM_COUNT = 10_000_000_000
ZETAN = 26.46902820178302
USED_ZIPFIAN_CONSTANT = 0.99
# Utils.fnvhash64's constants, as Java's signed longs.
FNV_OFFSET_BASIS_64 = 0xCBF29CE484222325 - (1 << 64)
FNV_PRIME_64 = 1099511628211

_GEN_CHUNK = 1 << 22  # keys drawn per device call: bounds the transient memory


@dataclasses.dataclass(frozen=True)
class Mix:
    """A traffic file's parameters (see the module's docstring)."""

    clients: int
    request_keys: int
    update_proportion: float
    pool_keys: int
    sample_reads: float  # share of read requests whose answers are compared
    warmup_rounds: int  # rounds run before the window (set-up)
    trace_rounds: int  # rounds a traced segment runs (``--trace 1``)

    @classmethod
    def from_traffic(cls, traffic: dict) -> "Mix":
        if traffic.get("generator") != "ycsb" or traffic.get("loop") != "closed":
            raise ValueError(f"not a closed-loop ycsb mix: {traffic}")
        if traffic.get("request_distribution") != "scrambled_zipfian":
            raise ValueError(f"unknown request_distribution in {traffic}")
        read = float(traffic["read_proportion"])
        update = float(traffic["update_proportion"])
        if abs(read + update - 1.0) > 1e-9:
            raise ValueError("read_proportion + update_proportion must be 1")
        mix = cls(
            clients=int(traffic["clients"]),
            request_keys=int(traffic["request_keys"]),
            update_proportion=update,
            pool_keys=int(traffic["pool_keys"]),
            sample_reads=float(traffic["sample_reads"]),
            warmup_rounds=int(traffic["warmup_rounds"]),
            trace_rounds=int(traffic["trace_rounds"]),
        )
        if mix.pool_keys % mix.request_keys or mix.pool_keys < mix.request_keys:
            raise ValueError("pool_keys must be a positive multiple of request_keys")
        return mix


def fnvhash64(val: torch.Tensor) -> torch.Tensor:
    """YCSB's ``Utils.fnvhash64`` over int64 values: FNV-1a of the eight
    bytes, low byte first, in wrapping 64-bit arithmetic, then
    ``Math.abs``."""
    h = torch.full_like(val, FNV_OFFSET_BASIS_64)
    v = val.clone()
    for _ in range(8):
        h = (h ^ (v & 0xFF)) * FNV_PRIME_64
        v = v >> 8
    return h.abs()


def zipfian_ranks(u: torch.Tensor) -> torch.Tensor:
    """``ZipfianGenerator(0, ITEM_COUNT, USED_ZIPFIAN_CONSTANT,
    ZETAN).nextValue()`` for each float64 uniform ``u``, as int64 ranks."""
    theta = USED_ZIPFIAN_CONSTANT
    items = ITEM_COUNT + 1  # ZipfianGenerator: max - min + 1
    zeta2theta = 1.0 + 0.5**theta
    alpha = 1.0 / (1.0 - theta)
    eta = (1.0 - (2.0 / items) ** (1.0 - theta)) / (1.0 - zeta2theta / ZETAN)
    uz = u * ZETAN
    tail = (items * torch.pow(eta * u - eta + 1.0, alpha)).to(torch.int64)  # (long) truncates
    ranks = torch.where(uz < 1.0 + 0.5**theta, torch.ones_like(tail), tail)
    return torch.where(uz < 1.0, torch.zeros_like(tail), ranks)


def scrambled_zipfian(n: int, record_count: int, generator: torch.Generator) -> torch.Tensor:
    """``n`` record indices in [0, record_count) from YCSB's
    ``ScrambledZipfianGenerator(0, record_count - 1)``, as int64 on
    ``generator``'s device."""
    u = torch.rand(n, dtype=torch.float64, generator=generator, device=generator.device)
    return torch.fmod(fnvhash64(zipfian_ranks(u)), record_count)  # Java's %


def draw_keys(n: int, keys: np.ndarray, generator: torch.Generator, tail: int = 0) -> np.ndarray:
    """``n`` keys of the records ``keys``, chosen by ``scrambled_zipfian``
    on ``generator``'s device in chunks (which bounds the transient device
    memory), on the host as int32, followed by the first ``tail`` of them
    again."""
    table = torch.from_numpy(np.ascontiguousarray(keys, np.int32)).to(generator.device)
    out = np.empty(n + tail, np.int32)
    for lo in range(0, n, _GEN_CHUNK):
        m = min(_GEN_CHUNK, n - lo)
        out[lo : lo + m] = table[scrambled_zipfian(m, keys.size, generator)].cpu().numpy()
    out[n:] = out[:tail]
    return out


class RequestPool:
    """Every request of a run, from the mix, the records' keys and a seed."""

    def __init__(self, mix: Mix, keys: np.ndarray, seed: int, device: str):
        self.mix = mix
        R = mix.request_keys
        self.n_requests = mix.pool_keys // R  # requests a pass
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        # the head repeated at the tail: every circular slice is one view
        self._keys = draw_keys(mix.pool_keys, keys, gen, tail=R)
        rng = np.random.default_rng([seed, 0x59C5B])
        n_writes = int(round(self.n_requests * mix.update_proportion))
        kinds = np.zeros(self.n_requests, bool)
        kinds[:n_writes] = True
        self.kinds = rng.permutation(kinds)  # True: a write
        self.sampled = rng.random(self.n_requests) < mix.sample_reads
        self.write_base = rng.integers(0, 2**31 - 1, R, dtype=np.int32)
        self._seed = seed
        self._offsets = {0: 0}

    def _offset(self, p: int) -> int:
        if p not in self._offsets:
            rng = np.random.default_rng([self._seed, 0x0FF5E7, p])
            self._offsets[p] = int(rng.integers(0, self.mix.pool_keys))
        return self._offsets[p]

    def is_write(self, seq: int) -> bool:
        return bool(self.kinds[seq % self.n_requests])

    def is_sampled(self, seq: int) -> bool:
        """Whether a read's answers are kept for the comparison."""
        return bool(self.sampled[seq % self.n_requests])

    def keys(self, seq: int) -> np.ndarray:
        R = self.mix.request_keys
        p, j = divmod(seq, self.n_requests)
        lo = (j * R + self._offset(p)) % self.mix.pool_keys
        return self._keys[lo : lo + R]

    def values(self, seq: int) -> np.ndarray:
        """A write's values (distinct from every earlier write's, lane by
        lane, since ``seq + 1`` is)."""
        return self.write_base ^ np.int32((seq + 1) & 0x7FFFFFFF)

    def request(self, seq: int) -> Tuple[bool, np.ndarray, Optional[np.ndarray]]:
        """``(is_write, keys, values or None)`` of submission ``seq``."""
        if self.is_write(seq):
            return True, self.keys(seq), self.values(seq)
        return False, self.keys(seq), None
