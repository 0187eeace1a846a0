"""Gradient-synchronization strategies — the SAGIPS contribution (Tab. II).

Counterpart of `repro.core.sync`: the strategy layer (`sync_gradients`,
`_sync_core`, lines 494–647) and the schedule layer (`SyncSchedule`,
`StaticSchedule`, `make_schedule`, lines 654–785), over any stacked-first
`ring.Comm`: the simulated ranks of `ring.VmapComm` or one worker process
of `runtime.proccomm.ProcComm`.

    mode            ring payload      mailbox   outer ring   combine
    --------------  ----------------  --------  -----------  ----------
    ensemble        none              no        no           —
    allreduce       full mean reduce  no        no           mean
    conv_arar       global ring       no        no           sum
    arar_arar       inner ring        no        every h      sum
    rma_arar_arar   inner ring        depth 1   every h      sum
    dbtree          log2(R) stages    no        no           mean

`mailbox` is the RMA window: what the ring predecessor deposited last
epoch; reading it never waits on the producer.  Per §V-C only weight
gradients ride the ring (`mask` from `gan.weight_mask`; unmasked leaves
skip the exchange).  With `fuse_tensors` (the default) the ring modes
concatenate the masked leaves into one flat [R, D] payload, laid out by a
`FusionSpec` in `jax.tree.leaves` order, so the offsets, and the flat
`outer_mailbox` a checkpoint holds, are the JAX package's.  Fused and
unfused runs are bitwise equal: the ring modes only roll and add.

The outer ring's predicate (`epoch % h == 0`, inner index 0) stays on the
device, so an epoch reads nothing back to the host.

Payload precision (`SyncConfig.payload_precision`, the JAX package's lines
108–119): the fused payload's wire dtype, 'fp32' or 'bf16'.  The cast
happens once on each side: `FusionSpec.flatten` packs to the payload dtype
(round to nearest even), and `FusionSpec.unflatten` casts back to each
destination leaf's dtype: fp32 into the gradients, the wire dtype into a
mailbox, so the RMA mailbox's masked leaves and the flat `outer_mailbox`
STORE bf16 and a proc deposit ships half the bytes.  Every combine runs in
the payload dtype (a bf16 add computes in fp32 and rounds, in torch as in
XLA), so the exchange at bf16 is bitwise the JAX package's on the same
payload.  Master parameters and the Adam state stay fp32.

Chunked ring (`SyncConfig.ring_chunking`, the JAX package's lines
121–141): a segment size in bytes, 0 for one unsegmented payload.
`FusionSpec.split_payload` cuts the flat payload into ceil(D · itemsize
/ ring_chunking) last-axis segments, counted in payload-dtype elements
(bf16 fits twice the elements in a segment), and the exchange runs on
their tuple: every `Comm` transfer maps over a tuple leaf by leaf, so
each segment is its own `torch.roll` on `VmapComm` and its own mmap
window on `ProcComm` (`window_bytes`).  Storage stays flat: the
segments are joined before the unpack, so mailboxes and checkpoints do
not depend on chunking, and a chunked exchange is bitwise the unchunked
one (the ring modes only roll and add elementwise).

Not ported yet, each raising `NotImplementedError` from `SyncConfig`
(ROADMAP.md queue A item 3): the depth-k mailbox (`staleness > 1`), the
overlapped pod boundary (`overlap`) and adaptive staleness (`adaptive`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from .ring import Comm
from .tree import tree_leaves, tree_map, tree_unflatten

MODES = ("ensemble", "allreduce", "conv_arar", "arar_arar", "rma_arar_arar",
         "dbtree")

# modes whose exchange rides the ring and therefore benefits from fusion
RING_MODES = ("conv_arar", "arar_arar", "rma_arar_arar", "dbtree")

PAYLOAD_PRECISIONS = ("fp32", "bf16")

# modes with a distinct inner/outer ring split
GROUPED_MODES = ("arar_arar", "rma_arar_arar")

SCHEDULE_ITEM = "ROADMAP.md queue A item 3 (the schedule layer)"


def payload_dtype_of(precision: str):
    """The torch dtype a `SyncConfig.payload_precision` value names."""
    if precision == "fp32":
        return torch.float32
    if precision == "bf16":
        return torch.bfloat16
    raise ValueError(
        f"unknown payload_precision {precision!r}; expected one of "
        f"{PAYLOAD_PRECISIONS}")


def _later(what: str):
    raise NotImplementedError(f"{what} is not ported yet: {SCHEDULE_ITEM}")


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    mode: str = "arar_arar"
    h: int = 1000                  # outer-group update frequency (Tab. I)
    combine: str = "sum"           # Algorithm 1 uses sum
    staleness: int = 1             # RMA mailbox depth k (paper: 1)
    fuse_tensors: bool = True      # one fused ring payload per exchange
    overlap: bool = False          # queue A item 3
    adaptive: bool = False         # queue A item 3
    payload_precision: str = "fp32"  # wire dtype of the fused payload
    ring_chunking: int = 0         # ring segment size in bytes (0: one)

    def __post_init__(self):
        # the JAX package's validation, message for message ...
        if self.mode not in MODES:
            raise ValueError(f"unknown sync mode {self.mode!r}")
        if self.payload_precision not in PAYLOAD_PRECISIONS:
            raise ValueError(
                f"unknown payload_precision {self.payload_precision!r}; "
                f"expected one of {PAYLOAD_PRECISIONS}")
        if self.payload_precision != "fp32" and not self.fuse_tensors:
            raise ValueError(
                "payload_precision applies to the FUSED flat ring payload "
                "(pack at flatten, unpack at scatter); set fuse_tensors=True")
        if self.payload_precision != "fp32" and self.mode not in RING_MODES:
            raise ValueError(
                "payload_precision only changes what rides the ring; mode="
                f"{self.mode!r} has no fused ring payload (ring modes: "
                f"{RING_MODES})")
        if self.staleness < 1:
            raise ValueError(f"staleness must be >= 1, got {self.staleness}")
        if self.staleness > 1 and self.mode != "rma_arar_arar":
            raise ValueError(
                "staleness > 1 (depth-k RMA mailbox) is only meaningful for "
                f"mode='rma_arar_arar', got mode={self.mode!r}")
        if self.overlap and self.mode not in GROUPED_MODES:
            raise ValueError(
                "overlap pipelines the outer (pod-boundary) ring segment, "
                f"which only the grouped modes {GROUPED_MODES} have; got "
                f"mode={self.mode!r}")
        if self.overlap and not self.fuse_tensors:
            raise ValueError(
                "overlap ships the FUSED payload across the pod boundary "
                "(the outer mailbox is stored in the flat [D] layout); "
                "set fuse_tensors=True")
        if self.adaptive and self.mode != "rma_arar_arar":
            raise ValueError(
                "adaptive staleness widens/narrows the RMA mailbox's "
                "effective read depth, which only mode='rma_arar_arar' "
                f"has; got mode={self.mode!r}")
        if self.adaptive and not self.fuse_tensors:
            raise ValueError(
                "adaptive staleness stores its max-depth mailbox in the "
                "fused flat [k_max, D] layout; set fuse_tensors=True")
        if self.ring_chunking < 0:
            raise ValueError(
                "ring_chunking is a segment size in bytes (0 = unchunked), "
                f"got {self.ring_chunking}")
        if self.ring_chunking and not self.fuse_tensors:
            raise ValueError(
                "ring_chunking splits the FUSED flat ring payload into "
                "pipelined segments; set fuse_tensors=True")
        if self.ring_chunking and self.mode not in RING_MODES:
            raise ValueError(
                "ring_chunking only changes how the fused ring payload "
                f"crosses the ring; mode={self.mode!r} has no ring payload "
                f"(ring modes: {RING_MODES})")
        # ... then what is valid there but not ported yet
        if self.staleness > 1:
            _later("the depth-k RMA mailbox (staleness > 1)")
        if self.overlap:
            _later("the overlapped pod-boundary exchange (overlap=True)")
        if self.adaptive:
            _later("adaptive staleness (adaptive=True, AdaptiveSchedule)")


# ----------------------------------------------------------------------------
# tensor fusion


@dataclasses.dataclass(frozen=True)
class _LeafSlot:
    masked: bool
    shape: Tuple[int, ...]         # per-rank trailing shape
    size: int
    offset: int                    # column offset into the flat payload
    dtype: Any


@dataclasses.dataclass(frozen=True, eq=False)
class FusionSpec:
    """Flat-payload layout for one tree + mask, built once per driver.

    `flatten` concatenates the mask-selected leaves, in `jax.tree.leaves`
    order, into one [D] (or stacked [R, D]) buffer; `unflatten` scatters
    an exchanged buffer back by the cached offsets.  `slots_tree` is the
    tree with each leaf's slot in its place."""
    slots_tree: Any
    slots: Tuple[_LeafSlot, ...]
    total: int                     # D = sum of masked per-rank leaf sizes
    payload_dtype: Any = torch.float32
    chunk_bytes: int = 0           # ring segment size in bytes (0: one)

    @classmethod
    def build(cls, example, mask, payload_dtype=None,
              chunk_bytes: int = 0) -> "FusionSpec":
        """`example` is a per-rank tree of tensors (shapes and dtypes are
        read; a "meta" tensor will do) and `mask` a matching bool tree.
        `payload_dtype` None takes the masked leaves' dtype;
        `chunk_bytes` is `SyncConfig.ring_chunking`."""
        slots, off = [], 0
        for m, g in zip(tree_leaves(mask), tree_leaves(example)):
            n = math.prod(g.shape)
            slots.append(_LeafSlot(bool(m), tuple(g.shape), n,
                                   off if m else -1, g.dtype))
            if m:
                off += n
        if payload_dtype is None:
            masked = [s.dtype for s in slots if s.masked]
            payload_dtype = masked[0] if masked else torch.float32
            for dt in masked[1:]:
                payload_dtype = torch.promote_types(payload_dtype, dt)
        return cls(tree_unflatten(example, slots), tuple(slots), off,
                   payload_dtype, int(chunk_bytes))

    def zero_payload(self, n_ranks: Optional[int] = None, device=None):
        """Zero flat payload: [D], or stacked [n_ranks, D]."""
        shape = (self.total,) if n_ranks is None else (n_ranks, self.total)
        return torch.zeros(shape, dtype=self.payload_dtype, device=device)

    def zeros(self, n_ranks: Optional[int] = None, device=None):
        """A zero tree in this spec's layout ([n_ranks, ...] stacked)."""
        lead = () if n_ranks is None else (n_ranks,)
        return tree_map(lambda s: torch.zeros(lead + s.shape, dtype=s.dtype,
                                              device=device), self.slots_tree)

    def flatten(self, tree, stacked: bool):
        """Masked leaves concatenated into the flat payload (cast to
        `payload_dtype`); stacked=True keeps the leading rank axis."""
        parts = [(g.reshape(g.shape[0], -1) if stacked else g.reshape(-1))
                 for s, g in zip(self.slots, tree_leaves(tree)) if s.masked]
        return torch.cat(parts, dim=1 if stacked else 0).to(
            self.payload_dtype)

    def unflatten(self, vec, tree, stacked: bool):
        """Scatter the payload back into `tree`'s masked leaves (each cast
        to that leaf's dtype); unmasked leaves pass through untouched."""
        out = []
        for s, g in zip(self.slots, tree_leaves(tree)):
            if s.masked:
                sl = vec[:, s.offset:s.offset + s.size] if stacked \
                    else vec[s.offset:s.offset + s.size]
                shape = (g.shape[0],) + s.shape if stacked else s.shape
                out.append(sl.reshape(shape).to(g.dtype))
            else:
                out.append(g)
        return tree_unflatten(tree, out)

    # -- chunked ring segments (SyncConfig.ring_chunking) --------------------

    def _per_segment(self) -> int:
        """Payload-dtype elements a segment."""
        return max(1, self.chunk_bytes // self.payload_dtype.itemsize)

    @property
    def n_segments(self) -> int:
        """1 unchunked or empty, else ceil(D / elements a segment)."""
        if self.chunk_bytes <= 0 or self.total == 0:
            return 1
        return -(-self.total // self._per_segment())

    def segment_bounds(self) -> Tuple[Tuple[int, int], ...]:
        """Half-open (start, end) element bounds of the segments, covering
        [0, D); the last one holds the remainder."""
        if self.n_segments == 1:
            return ((0, self.total),)
        per = self._per_segment()
        return tuple((a, min(a + per, self.total))
                     for a in range(0, self.total, per))

    def split_payload(self, vec):
        """Flat payload [..., D] -> tuple of last-axis segment views."""
        return tuple(vec[..., a:b] for a, b in self.segment_bounds())

    def join_payload(self, segs):
        """Inverse of `split_payload`: the flat [..., D] payload."""
        if len(segs) == 1:
            return segs[0]
        return torch.cat(segs, dim=-1)


def _comb(a, b, combine):
    out = a + b
    return out * 0.5 if combine == "mean" else out


def _masked(mask, synced, local):
    """Apply sync only to leaves where mask is True (weights, not biases)."""
    if mask is None:
        return synced
    return tree_map(lambda m, s, l: s if m else l, mask, synced, local)


def init_mailbox(grads_like):
    """Zero RMA mailbox shaped like `grads_like` (depth 1; the depth-k
    circular buffer is ROADMAP.md queue A item 3)."""
    return tree_map(torch.zeros_like, grads_like)


def _outer_exchange(comm: Comm, g, epoch, h, combine):
    """Outer-group ring every h epochs, only for inner-rank-0 members.
    `epoch` may be a device tensor: the predicate stays on the device."""
    recv = comm.recv_ring_outer(g)
    exchanged = tree_map(lambda a, b: _comb(a, b, combine), g, recv)
    dev = tree_leaves(g)[0].device
    due = torch.as_tensor(epoch, device=dev) % h == 0
    is_member = comm.inner_index(dev) == 0           # paper fixes rank 0
    return comm.mask_where(due & is_member, exchanged, g)


def sync_gradients(comm: Comm, cfg: SyncConfig, grads, mailbox, epoch,
                   mask=None, spec: Optional[FusionSpec] = None,
                   outer_mailbox=None):
    """Returns (synced_grads, new_mailbox), or a 3-tuple with the outer
    mailbox when `outer_mailbox` is passed (it passes through untouched:
    only the overlap schedule, queue A item 3, writes it).

    `spec` is the cached FusionSpec of the fused path; when omitted it is
    rebuilt from `grads`/`mask`."""
    fuse = cfg.fuse_tensors and mask is not None and cfg.mode in RING_MODES
    if fuse and spec is None:
        example = tree_map(lambda x: x[0], grads)
        spec = FusionSpec.build(
            example, mask, payload_dtype=payload_dtype_of(
                cfg.payload_precision), chunk_bytes=cfg.ring_chunking)
    if fuse and spec.total > 0:     # all-False mask: nothing rides the ring
        fg, fmb = spec.flatten(grads, True), spec.flatten(mailbox, True)
        nseg = spec.n_segments
        if nseg > 1:
            # the chunked ring: a tuple of segments, each its own transfer;
            # unchunked keeps the bare payload, not a 1-tuple
            fg, fmb = spec.split_payload(fg), spec.split_payload(fmb)
        fsynced, fnew_mb = _sync_core(
            comm, cfg, {"w": fg}, {"w": fmb}, epoch,
            {"w": (True,) * nseg if nseg > 1 else True})
        if nseg > 1:                # storage stays flat
            fsynced = {"w": spec.join_payload(fsynced["w"])}
            fnew_mb = {"w": spec.join_payload(fnew_mb["w"])}
        synced = spec.unflatten(fsynced["w"], grads, True)
        new_mailbox = spec.unflatten(fnew_mb["w"], mailbox, True)
    else:
        synced, new_mailbox = _sync_core(comm, cfg, grads, mailbox, epoch,
                                         mask)
    if outer_mailbox is None:
        return synced, new_mailbox
    return synced, new_mailbox, outer_mailbox


def _sync_core(comm: Comm, cfg: SyncConfig, grads, mailbox, epoch,
               mask=None):
    """Returns (synced, new_mailbox)."""
    mode, combine = cfg.mode, cfg.combine
    if mode == "ensemble":
        return grads, mailbox
    if mode == "allreduce":
        return _masked(mask, comm.pmean_all(grads), grads), mailbox
    if mode == "conv_arar":
        recv = comm.recv_ring_all(grads)
        synced = tree_map(lambda a, b: _comb(a, b, combine), grads, recv)
        return _masked(mask, synced, grads), mailbox
    if mode == "dbtree":
        # recursive doubling: a full reduction in log2(R) pairwise stages,
        # normalized to the mean (comparable to allreduce)
        R = comm.n_ranks
        if R & (R - 1):
            raise ValueError(f"dbtree needs a power-of-two rank count, got "
                             f"{R}")
        synced = grads
        for stage in range(int(math.log2(R))):
            recv = comm.recv_hypercube(synced, stage)
            synced = tree_map(lambda a, b: a + b, synced, recv)
        synced = tree_map(lambda x: x / R, synced)
        return _masked(mask, synced, grads), mailbox

    if mode == "arar_arar":
        recv = comm.recv_ring_inner(grads)
        synced = tree_map(lambda a, b: _comb(a, b, combine), grads, recv)
        new_mailbox = mailbox
    elif mode == "rma_arar_arar":
        # read the stale mailbox (never waits on the producer) ...
        synced = tree_map(lambda a, b: _comb(a, b, combine), grads, mailbox)
        # ... and deposit this epoch's fresh local grads for the successor;
        # unmasked mailbox leaves keep their old (never-read) contents
        new_mailbox = _masked(mask, comm.recv_ring_inner(grads), mailbox)
    else:
        raise ValueError(f"unknown sync mode {mode!r}")

    if comm.n_outer > 1:
        synced = _outer_exchange(comm, synced, epoch, cfg.h, combine)
    return _masked(mask, synced, grads), new_mailbox


# ----------------------------------------------------------------------------
# the schedule layer


class SyncSchedule:
    """A gradient-sync schedule: owns its SyncState and per-epoch exchange.

      * `init_state(n_ranks, device) -> SyncState`, the tree that rides in
        the training state as `state["sync"]`;
      * `exchange(comm, grads, sync_state, epoch) -> (synced, new_state)`.

    Build instances with `make_schedule`."""

    def __init__(self, cfg: SyncConfig, mask, spec: FusionSpec):
        self.cfg, self.mask, self.spec = cfg, mask, spec

    def init_state(self, n_ranks: int, device=None):
        raise NotImplementedError

    def exchange(self, comm: Comm, grads, sync_state, epoch):
        raise NotImplementedError


class StaticSchedule(SyncSchedule):
    """The synchronous schedule at depth 1: exactly `sync_gradients`.

    SyncState = {"mailbox": <grads-shaped tree>, "outer_mailbox": <flat
    [R, D] payload>}, the JAX package's layout (the outer mailbox stays
    zero until the overlap schedule of queue A item 3 writes it).  The
    mailbox's masked leaves are stored in the payload dtype, what the
    ring deposits; unmasked leaves never ride it and keep their own."""

    def init_state(self, n_ranks: int, device=None):
        example = self.spec.zeros(n_ranks, device)
        if self.mask is not None:
            example = tree_map(
                lambda m, x: x.to(self.spec.payload_dtype) if m else x,
                self.mask, example)
        return {"mailbox": init_mailbox(example),
                "outer_mailbox": self.spec.zero_payload(n_ranks, device)}

    def exchange(self, comm: Comm, grads, sync_state, epoch):
        synced, new_mb, new_omb = sync_gradients(
            comm, self.cfg, grads, sync_state["mailbox"], epoch, self.mask,
            spec=self.spec, outer_mailbox=sync_state["outer_mailbox"])
        return synced, {"mailbox": new_mb, "outer_mailbox": new_omb}


def make_schedule(cfg: SyncConfig, mask, spec: FusionSpec) -> SyncSchedule:
    """The schedule of `cfg`: every configuration `SyncConfig` accepts in
    the port is the static one (adaptive raises there)."""
    return StaticSchedule(cfg, mask, spec)
