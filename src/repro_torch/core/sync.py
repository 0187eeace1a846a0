"""Gradient-synchronization strategies — the SAGIPS contribution (Tab. II).

Counterpart of `repro.core.sync`: the strategy layer (`sync_gradients`,
`_sync_core`, lines 494–647) and the schedule layer (`SyncSchedule`,
`StaticSchedule`, `AdaptiveSchedule`, `make_schedule`, lines 654–1065,
with the metrics channel), over any stacked-first
`ring.Comm`: the simulated ranks of `ring.VmapComm` or one worker process
of `runtime.proccomm.ProcComm`.

    mode            ring payload      mailbox   outer ring   combine
    --------------  ----------------  --------  -----------  ----------
    ensemble        none              no        no           —
    allreduce       full mean reduce  no        no           mean
    conv_arar       global ring       no        no           sum
    arar_arar       inner ring        no        every h      sum
    rma_arar_arar   inner ring        depth k   every h      sum
    dbtree          log2(R) stages    no        no           mean

`mailbox` is the RMA window: what the ring predecessor deposited
`staleness` epochs ago; reading it never waits on the producer.  Per
§V-C only weight gradients ride the ring (`mask` from `gan.weight_mask`;
unmasked leaves skip the exchange).  With `fuse_tensors` (the default)
the ring modes concatenate the masked leaves into one flat [R, D]
payload, laid out by a `FusionSpec` in `jax.tree.leaves` order, so the
offsets, and the flat `outer_mailbox` a checkpoint holds, are the JAX
package's.  Fused and unfused runs are bitwise equal: the ring modes only
roll and add.

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

Depth-k mailbox (`SyncConfig.staleness`, rma_arar_arar only; the JAX
package's lines 67–75 and 519–583): a circular buffer of k slots, a depth
axis after the rank axis of every mailbox leaf ([R, k, ...]; k = 1 keeps
the flat layout).  At epoch e a rank reads slot e % k, its predecessor's
deposit of epoch e - k (zeros for the first k epochs), exchanges it as at
depth 1 (fused, chunked, bf16 alike) and deposits this epoch's fresh
payload into the same slot, out of place.  The slot index is computed on
the device from the epoch counter (`index_select`, `index_copy`), so the
exchange reads nothing back at any depth.  Only the fresh payload crosses
the ring: a `ProcComm` worker's depth-k buffer is its local state.

Metrics channel (`ObsConfig.metrics`; the JAX package's lines 694–802):
the schedule owns an obs tree as it owns its SyncState.
`exchange_with_obs` returns the exchange and one row (k_eff: `staleness`
in `rma_arar_arar`, else 0; skew, deposit age and the ship flag 0, the
lock-step facts of the static schedule), and `accumulate_obs` folds it
into the cumulative tree (gauges overwrite, counts add).  Every leaf is
made and updated on the device, so an epoch reads nothing back;
`payload_bytes` is the fused payload in its wire dtype and `name` the
schedule's name for the metrics file's header.

Overlapped pod boundary (`SyncConfig.overlap`, the grouped modes; the
JAX package's lines 455–491): the outer ring's hop moves off the epoch
that reads it.  A due epoch (`epoch % h == 0`, inner index 0) adds the
flat outer mailbox, what the predecessor pod shipped the epoch before
(zeros before the first ship), instead of this epoch's outer roll; the
epoch before a due one (`(epoch + 1) % h == 0`) ships its inner-synced
payload into that mailbox (`Comm.cond_ship`), and every other epoch
leaves it as it is.  Both predicates stay device tensors.  The mailbox
is stored flat in the payload dtype, cut into the ring's segments and
joined back around the exchange, so chunked and whole are bitwise equal.
The metrics row's ship flag is `(epoch + 1) % h == 0` under overlap
with more than one pod, made on the device.

Adaptive staleness (`SyncConfig.adaptive`, rma_arar_arar with a fused
payload; the JAX package's lines 805–1065): `AdaptiveSchedule` keeps a
max-depth mailbox of k_max = `staleness` slots, each deposit tagged with
its producer's epoch (`ring.make_deposit_tag`), and reads the slot
deposited k_eff epochs ago.  A controller (`adaptive_controller_step`)
smooths the observed skew, `epoch - tag - k_eff` clamped at 0 and
averaged over the ranks (`Comm.pmean_all`), into an EMA and moves
k_eff in [1, k_max] with a deadband; under overlap the ship gate opens
up to k_eff epochs before a due one, once a cycle (`shipped_for`).  The
payload and its tag cross the ring as one tree, and the deposit enters
`_sync_core` through its `deposit` argument.  On `VmapComm` every rank
deposits at the same epoch, so the skew is 0, k_eff stays 1 and the run
is bitwise depth-1 rma_arar_arar; free-running `ProcComm` workers
measure a real skew.  Slot, tag, controller and gate stay on the
device, so an epoch on `VmapComm` reads nothing back.

Schedules (`make_schedule`): `StaticSchedule` (`name` "sync" or
"overlap") for every configuration but `adaptive`, which builds
`AdaptiveSchedule` (`name` "adaptive").
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from .ring import Comm, make_deposit_tag
from .tree import tree_leaves, tree_map, tree_unflatten

MODES = ("ensemble", "allreduce", "conv_arar", "arar_arar", "rma_arar_arar",
         "dbtree")

# modes whose exchange rides the ring and therefore benefits from fusion
RING_MODES = ("conv_arar", "arar_arar", "rma_arar_arar", "dbtree")

PAYLOAD_PRECISIONS = ("fp32", "bf16")

# modes with a distinct inner/outer ring split
GROUPED_MODES = ("arar_arar", "rma_arar_arar")

# dtype of the obs tree's float gauges (the JAX package's CTRL_DTYPE)
CTRL_DTYPE = torch.float32


def payload_dtype_of(precision: str):
    """The torch dtype a `SyncConfig.payload_precision` value names."""
    if precision == "fp32":
        return torch.float32
    if precision == "bf16":
        return torch.bfloat16
    raise ValueError(
        f"unknown payload_precision {precision!r}; expected one of "
        f"{PAYLOAD_PRECISIONS}")


@dataclasses.dataclass(frozen=True)
class SyncConfig:
    mode: str = "arar_arar"
    h: int = 1000                  # outer-group update frequency (Tab. I)
    combine: str = "sum"           # Algorithm 1 uses sum
    staleness: int = 1             # RMA mailbox depth k (paper: 1)
    fuse_tensors: bool = True      # one fused ring payload per exchange
    overlap: bool = False          # pipelined pod-boundary exchange
    adaptive: bool = False         # adaptive staleness (AdaptiveSchedule)
    payload_precision: str = "fp32"  # wire dtype of the fused payload
    ring_chunking: int = 0         # ring segment size in bytes (0: one)

    def __post_init__(self):
        # the JAX package's validation, message for message
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


def init_mailbox(grads_like, staleness: int = 1, stacked: bool = False):
    """Zero RMA mailbox shaped like `grads_like`.  `staleness` k > 1 adds a
    circular-buffer depth axis of size k to every leaf, at position 1 when
    the tree is rank-stacked ([R, k, ...]), else leading ([k, ...]); k = 1
    keeps the flat layout (no depth axis)."""
    if staleness <= 1:
        return tree_map(torch.zeros_like, grads_like)
    axis = 1 if stacked else 0
    return tree_map(
        lambda x: torch.zeros(x.shape[:axis] + (staleness,) + x.shape[axis:],
                              dtype=x.dtype, device=x.device), grads_like)


def _outer_exchange(comm: Comm, g, epoch, h, combine):
    """Outer-group ring every h epochs, only for inner-rank-0 members.
    `epoch` may be a device tensor: the predicate stays on the device."""
    recv = comm.recv_ring_outer(g)
    exchanged = tree_map(lambda a, b: _comb(a, b, combine), g, recv)
    dev = tree_leaves(g)[0].device
    due = torch.as_tensor(epoch, device=dev) % h == 0
    is_member = comm.inner_index(dev) == 0           # paper fixes rank 0
    return comm.mask_where(due & is_member, exchanged, g)


def _outer_exchange_overlapped(comm: Comm, g, outer_mb, epoch, h, combine,
                               ship_due=None):
    """The pipelined pod-boundary exchange: consume the outer mailbox, and
    ship for the next epoch.  A due epoch (`epoch % h == 0`) adds the
    mailbox, the predecessor pod's inner-synced payload shipped one epoch
    before, on the inner-rank-0 members; the ship (`Comm.cond_ship`)
    sends this epoch's `g` into the mailbox where `ship_due` holds
    (default: the next epoch is due, `(epoch + 1) % h == 0`) and leaves
    the mailbox as it is elsewhere.  Both predicates are device tensors.
    Returns (synced, new_outer_mailbox)."""
    exchanged = tree_map(lambda a, b: _comb(a, b, combine), g, outer_mb)
    dev = tree_leaves(g)[0].device
    epoch = torch.as_tensor(epoch, device=dev)
    is_member = comm.inner_index(dev) == 0
    synced = comm.mask_where((epoch % h == 0) & is_member, exchanged, g)
    if ship_due is None:
        ship_due = (epoch + 1) % h == 0
    return synced, comm.cond_ship(ship_due, g, outer_mb)


def sync_gradients(comm: Comm, cfg: SyncConfig, grads, mailbox, epoch,
                   mask=None, spec: Optional[FusionSpec] = None,
                   outer_mailbox=None):
    """Returns (synced_grads, new_mailbox), or a 3-tuple with the new outer
    mailbox when `outer_mailbox` is passed.

    `spec` is the cached FusionSpec of the fused path; when omitted it is
    rebuilt from `grads`/`mask`.  At `staleness` k > 1 (rma_arar_arar)
    `mailbox` is the [R, k, ...] circular buffer (`init_mailbox`): the
    exchange runs on slot `epoch % k` and its deposit is written back
    into that slot; the mailbox's unmasked leaves never ride the ring and
    are returned as they came.

    `outer_mailbox` is the overlap schedule's pod-boundary window, the
    flat [R, D] payload (`FusionSpec.zero_payload`).  `cfg.overlap`
    needs it; otherwise it passes through untouched, so a training loop
    threads it whatever the schedule."""
    if cfg.overlap and outer_mailbox is None:
        raise ValueError(
            "cfg.overlap=True needs the pod-boundary outer mailbox "
            "(build it with FusionSpec.zero_payload)")
    depth = cfg.staleness if cfg.mode == "rma_arar_arar" else 1
    if depth > 1:
        full = mailbox
        # slot epoch % k as a [1] index on the device: a device counter
        # stays there, nothing is read back
        slot = (torch.as_tensor(epoch, device=tree_leaves(grads)[0].device)
                % depth).reshape(1).to(torch.int64)
        rides = [True] * len(tree_leaves(full)) if mask is None \
            else [bool(m) for m in tree_leaves(mask)]
        # an unmasked slot is never read: a view of slot 0 stands in
        mailbox = tree_unflatten(full, [
            x.index_select(1, slot).squeeze(1) if r else x[:, 0]
            for r, x in zip(rides, tree_leaves(full))])
    fuse = cfg.fuse_tensors and mask is not None and cfg.mode in RING_MODES
    if fuse and spec is None:
        example = tree_map(lambda x: x[0], grads)
        spec = FusionSpec.build(
            example, mask, payload_dtype=payload_dtype_of(
                cfg.payload_precision), chunk_bytes=cfg.ring_chunking)
    new_outer = outer_mailbox
    if fuse and spec.total > 0:     # all-False mask: nothing rides the ring
        fg, fmb = spec.flatten(grads, True), spec.flatten(mailbox, True)
        # the outer mailbox is stored flat already
        fomb = outer_mailbox if cfg.overlap else None
        nseg = spec.n_segments
        if nseg > 1:
            # the chunked ring: a tuple of segments, each its own transfer;
            # unchunked keeps the bare payload, not a 1-tuple
            fg, fmb = spec.split_payload(fg), spec.split_payload(fmb)
            if fomb is not None:
                fomb = spec.split_payload(fomb)
        fsynced, fnew_mb, fnew_omb = _sync_core(
            comm, cfg, {"w": fg}, {"w": fmb}, epoch,
            {"w": (True,) * nseg if nseg > 1 else True},
            outer_mb=None if fomb is None else {"w": fomb})
        if nseg > 1:                # storage stays flat
            fsynced = {"w": spec.join_payload(fsynced["w"])}
            fnew_mb = {"w": spec.join_payload(fnew_mb["w"])}
            if fnew_omb is not None:
                fnew_omb = {"w": spec.join_payload(fnew_omb["w"])}
        synced = spec.unflatten(fsynced["w"], grads, True)
        new_mailbox = spec.unflatten(fnew_mb["w"], mailbox, True)
        if fnew_omb is not None:
            new_outer = fnew_omb["w"]
    else:
        synced, new_mailbox, _ = _sync_core(comm, cfg, grads, mailbox, epoch,
                                            mask)
    if depth > 1:
        # this epoch's deposit into the slot it was read from, out of
        # place: the previous state may still be held elsewhere
        new_mailbox = tree_unflatten(full, [
            f.index_copy(1, slot, n.unsqueeze(1).to(f.dtype)) if r else f
            for r, f, n in zip(rides, tree_leaves(full),
                               tree_leaves(new_mailbox))])
    if outer_mailbox is None:
        return synced, new_mailbox
    return synced, new_mailbox, new_outer


def _sync_core(comm: Comm, cfg: SyncConfig, grads, mailbox, epoch,
               mask=None, outer_mb=None, ship_due=None, deposit=None):
    """Returns (synced, new_mailbox, new_outer_mb).  `outer_mb` is read
    and written only by the grouped modes under `cfg.overlap`, with more
    than one pod; every other path passes it through.  `ship_due`
    overrides the overlap ship's predicate (None: the next epoch is
    due).  `deposit` is the rma mode's fresh deposit when the caller
    already received it (the adaptive schedule's bundled payload and
    tag); None receives it here with `recv_ring_inner(grads)`."""
    mode, combine = cfg.mode, cfg.combine
    if mode == "ensemble":
        return grads, mailbox, outer_mb
    if mode == "allreduce":
        return _masked(mask, comm.pmean_all(grads), grads), mailbox, outer_mb
    if mode == "conv_arar":
        recv = comm.recv_ring_all(grads)
        synced = tree_map(lambda a, b: _comb(a, b, combine), grads, recv)
        return _masked(mask, synced, grads), mailbox, outer_mb
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
        return _masked(mask, synced, grads), mailbox, outer_mb

    if mode == "arar_arar":
        recv = comm.recv_ring_inner(grads)
        synced = tree_map(lambda a, b: _comb(a, b, combine), grads, recv)
        new_mailbox = mailbox
    elif mode == "rma_arar_arar":
        # read the stale mailbox (never waits on the producer) ...
        synced = tree_map(lambda a, b: _comb(a, b, combine), grads, mailbox)
        # ... and deposit this epoch's fresh local grads for the successor;
        # unmasked mailbox leaves keep their old (never-read) contents
        if deposit is None:
            deposit = comm.recv_ring_inner(grads)
        new_mailbox = _masked(mask, deposit, mailbox)
    else:
        raise ValueError(f"unknown sync mode {mode!r}")

    if comm.n_outer > 1:
        if cfg.overlap and outer_mb is not None:
            synced, outer_mb = _outer_exchange_overlapped(
                comm, synced, outer_mb, epoch, cfg.h, combine,
                ship_due=ship_due)
        else:
            synced = _outer_exchange(comm, synced, epoch, cfg.h, combine)
    return _masked(mask, synced, grads), new_mailbox, outer_mb


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

    @property
    def name(self) -> str:
        raise NotImplementedError

    def init_state(self, n_ranks: int, device=None):
        raise NotImplementedError

    def exchange(self, comm: Comm, grads, sync_state, epoch):
        raise NotImplementedError

    # -- the metrics channel (the JAX package's lines 694-758) ---------------
    # The schedule owns the obs tree as it owns its SyncState; the loops
    # call these only when `ObsConfig.metrics` is on, so a run without it
    # takes the plain `exchange` path and its state has no "obs" key.

    @property
    def payload_bytes(self) -> int:
        """Bytes a rank sends on the inner ring each exchange: the fused
        payload in its wire dtype (what `ProcComm` deposits)."""
        return self.spec.total * self.spec.payload_dtype.itemsize

    def init_obs_state(self, n_ranks: Optional[int] = None, device=None):
        """Zero cumulative obs tree (rides as `state["obs"]`): the last
        exchange's k_eff, skew, deposit age and ship flag, and running
        ship and exchange counts; leaves [n_ranks] ([] for None)."""
        lead = () if n_ranks is None else (n_ranks,)

        def zeros(dtype):
            return torch.zeros(lead, dtype=dtype, device=device)
        return {
            "k_eff": zeros(torch.int32),
            "skew_ema": zeros(CTRL_DTYPE),
            "deposit_age": zeros(CTRL_DTYPE),
            "shipped": zeros(torch.int32),
            "ship_count": zeros(torch.int32),
            "exchange_count": zeros(torch.int32),
        }

    @staticmethod
    def accumulate_obs(obs_state, row):
        """Fold one exchange's obs row into the cumulative tree, on the
        device: gauges overwrite, counts add."""
        return {
            "k_eff": row["k_eff"],
            "skew_ema": row["skew_ema"],
            "deposit_age": row["deposit_age"],
            "shipped": row["shipped"],
            "ship_count": obs_state["ship_count"] + row["shipped"],
            "exchange_count": obs_state["exchange_count"] + 1,
        }

    def obs_row(self, comm: Comm, sync_state, epoch):
        """One exchange's obs row (k_eff, skew_ema, deposit_age, shipped),
        leaves in the sync state's rank layout."""
        raise NotImplementedError

    def exchange_with_obs(self, comm: Comm, grads, sync_state, epoch):
        """`exchange` plus its obs row: `(synced, new_state, row)`."""
        synced, new_state = self.exchange(comm, grads, sync_state, epoch)
        return synced, new_state, self.obs_row(comm, new_state, epoch)


class StaticSchedule(SyncSchedule):
    """The config-time schedules, sync and overlap, at any RMA depth:
    exactly `sync_gradients`.

    SyncState = {"mailbox": <grads-shaped tree, [R, k, ...] at staleness
    k > 1>, "outer_mailbox": <flat [R, D] payload>}, the JAX package's
    layout (the outer mailbox stays zero unless `overlap` ships into it).
    The mailbox's masked leaves and the outer mailbox are stored in the
    payload dtype, what the ring deposits; unmasked leaves never ride it
    and keep their own."""

    @property
    def name(self) -> str:
        return "overlap" if self.cfg.overlap else "sync"

    def init_state(self, n_ranks: int, device=None):
        example = self.spec.zeros(n_ranks, device)
        if self.mask is not None:
            example = tree_map(
                lambda m, x: x.to(self.spec.payload_dtype) if m else x,
                self.mask, example)
        return {"mailbox": init_mailbox(example, self.cfg.staleness,
                                        stacked=n_ranks is not None),
                "outer_mailbox": self.spec.zero_payload(n_ranks, device)}

    def exchange(self, comm: Comm, grads, sync_state, epoch):
        synced, new_mb, new_omb = sync_gradients(
            comm, self.cfg, grads, sync_state["mailbox"], epoch, self.mask,
            spec=self.spec, outer_mailbox=sync_state["outer_mailbox"])
        return synced, {"mailbox": new_mb, "outer_mailbox": new_omb}

    def obs_row(self, comm: Comm, sync_state, epoch):
        # static facts restated as data, made on the device: a depth-k RMA
        # read is `staleness` epochs old, the lock-step exchange has no
        # skew, and overlap ships on the fixed h-cadence
        omb = sync_state["outer_mailbox"]
        lead, dev = omb.shape[:-1], omb.device
        k = self.cfg.staleness if self.cfg.mode == "rma_arar_arar" else 0
        shipped = torch.zeros(lead, dtype=torch.int32, device=dev)
        if self.cfg.overlap and comm.n_outer > 1:
            due = (torch.as_tensor(epoch, device=dev) + 1) % self.cfg.h == 0
            shipped = due.to(torch.int32).expand(lead)
        return {
            "k_eff": torch.full(lead, k, dtype=torch.int32, device=dev),
            "skew_ema": torch.zeros(lead, dtype=CTRL_DTYPE, device=dev),
            "deposit_age": torch.zeros(lead, dtype=CTRL_DTYPE, device=dev),
            "shipped": shipped,
        }


# the adaptive controller's constants: the EMA's smoothing of the observed
# skew, and the deadband that holds k_eff while the EMA hovers at a
# rounding boundary
ADAPT_ALPHA = 0.2
ADAPT_DEADBAND = 0.25


def adaptive_k_eff(skew_ema, k_max: int):
    """The read depth the smoothed skew implies: 1 + round(ema) (half to
    even, as `jnp.round`), clipped to [1, k_max], int32."""
    return torch.clamp(torch.round(1.0 + skew_ema), 1, k_max).to(torch.int32)


def adaptive_controller_step(ctrl, observed_skew, k_max: int,
                             alpha: float = ADAPT_ALPHA,
                             deadband: float = ADAPT_DEADBAND):
    """One EMA step of the staleness controller, on the device: the EMA
    takes `(1 - alpha)·ema + alpha·skew` in fp32, in that order, and
    k_eff moves to `adaptive_k_eff(ema)` only when the implied depth
    `1 + ema` lies more than `0.5 + deadband` from the current one
    (deadband 0: the plain rounding controller).  Zero skew decays the
    EMA to 0 and holds k_eff at 1.  `ctrl` holds "skew_ema" (fp32) and
    "k_eff" (int32) in any layout; returns them stepped."""
    ema = (1.0 - alpha) * ctrl["skew_ema"] + alpha * observed_skew
    k_cur = torch.clamp(ctrl["k_eff"], 1, k_max).to(torch.int32)
    implied = 1.0 + ema
    move = (implied - k_cur.to(CTRL_DTYPE)).abs() > 0.5 + deadband
    k_new = torch.where(move, adaptive_k_eff(ema, k_max), k_cur)
    return {"skew_ema": ema, "k_eff": k_new.to(torch.int32)}


class AdaptiveSchedule(SyncSchedule):
    """Adaptive staleness (`SyncConfig.adaptive`, mode rma_arar_arar).

    SyncState, with the leading rank axis [L] (R on `VmapComm`, 1 in a
    `ProcComm` worker):
      mailbox.payload  [L, k_max, D] in the payload dtype: slot e % k_max
                       takes epoch e's deposit, slot (e - k_eff) % k_max
                       is read
      mailbox.tag      [L, k_max] int32, each slot's producer epoch (-1:
                       never written; such a read is the zero payload and
                       counts 0 skew)
      outer_mailbox    [L, D], the overlap pod-boundary window
      ctrl.skew_ema    [L] fp32, the EMA of the observed skew
      ctrl.k_eff       [L] int32, the read depth, always in [1, k_max]
      ctrl.shipped_for [L] int32, the due epoch the last overlap ship
                       served (-1: none), so the stretched gate ships once
                       a cycle however k_eff moves

    The controller is pmean-reduced, so the ranks of one `VmapComm` hold
    the same k_eff; rank 0's copy picks the slot, as in the JAX package.
    Every step is a device op on the epoch counter: no read-back."""

    @property
    def name(self) -> str:
        return "adaptive"

    @property
    def k_max(self) -> int:
        return self.cfg.staleness

    def init_state(self, n_ranks: Optional[int], device=None):
        lead = () if n_ranks is None else (n_ranks,)
        return {
            "mailbox": {
                "payload": torch.zeros(lead + (self.k_max, self.spec.total),
                                       dtype=self.spec.payload_dtype,
                                       device=device),
                "tag": torch.full(lead + (self.k_max,), -1,
                                  dtype=torch.int32, device=device),
            },
            "outer_mailbox": self.spec.zero_payload(n_ranks, device),
            "ctrl": {
                "skew_ema": torch.zeros(lead, dtype=CTRL_DTYPE,
                                        device=device),
                "k_eff": torch.ones(lead, dtype=torch.int32, device=device),
                "shipped_for": torch.full(lead, -1, dtype=torch.int32,
                                          device=device),
            },
        }

    def exchange(self, comm: Comm, grads, sync_state, epoch):
        synced, new_state, _ = self._exchange(comm, grads, sync_state,
                                              epoch, with_obs=False)
        return synced, new_state

    def exchange_with_obs(self, comm: Comm, grads, sync_state, epoch):
        # the row holds the exchange's own values: the post-step k_eff and
        # EMA, the clamped observed age and the ship decision
        return self._exchange(comm, grads, sync_state, epoch, with_obs=True)

    def _exchange(self, comm: Comm, grads, sync_state, epoch,
                  with_obs: bool):
        cfg, spec, k_max = self.cfg, self.spec, self.k_max
        payload = sync_state["mailbox"]["payload"]
        tags = sync_state["mailbox"]["tag"]
        ctrl = sync_state["ctrl"]
        obs_shape = ctrl["skew_ema"].shape       # the rank layout [L]
        dev = payload.device
        if spec.total == 0:        # all-False mask: nothing rides the ring
            row = {
                "k_eff": ctrl["k_eff"].expand(obs_shape),
                "skew_ema": ctrl["skew_ema"],
                "deposit_age": torch.zeros(obs_shape, dtype=CTRL_DTYPE,
                                           device=dev),
                "shipped": torch.zeros(obs_shape, dtype=torch.int32,
                                       device=dev),
            } if with_obs else None
            return grads, sync_state, row
        epoch = torch.as_tensor(epoch, device=dev)

        # -- read the slot deposited k_eff epochs ago (a [1] device index;
        # `%` is a floor modulo: epoch - k_eff is negative at epoch 0)
        k_eff = ctrl["k_eff"][0]
        slot_r = ((epoch - k_eff) % k_max).reshape(1).to(torch.int64)
        mb_flat = payload.index_select(1, slot_r).squeeze(1)
        tag_read = tags.index_select(1, slot_r).squeeze(1)

        # -- the controller: the observed age beyond k_eff, clamped at 0
        # (only a lagging producer widens the window), 0 for an unwritten
        # slot, averaged over the ranks
        observed = torch.where(
            tag_read >= 0, (epoch - tag_read - k_eff).to(CTRL_DTYPE),
            torch.zeros_like(tag_read, dtype=CTRL_DTYPE))
        observed = torch.clamp_min(observed, 0.0)
        skew = comm.pmean_all(observed)
        new_ctrl = adaptive_controller_step(
            {"skew_ema": ctrl["skew_ema"], "k_eff": ctrl["k_eff"]}, skew,
            k_max)
        new_k = new_ctrl["k_eff"][0]

        # -- the overlap ship gate, stretched by k_eff: open at the first
        # epoch within `lead` of the next due one, once a cycle
        shipped_for = ctrl["shipped_for"]
        sf = shipped_for[0]
        lead = torch.clamp(new_k, 1, cfg.h)
        to_due = cfg.h - epoch % cfg.h
        next_due = epoch + to_due
        ship_now = (to_due <= lead) & (sf != next_due)
        if cfg.overlap:
            new_ctrl["shipped_for"] = torch.where(
                ship_now, next_due, sf).to(torch.int32).expand(
                    shipped_for.shape)
        else:                      # no pod-boundary pipeline: no ships
            new_ctrl["shipped_for"] = shipped_for

        # -- payload and tag cross the ring in one transfer, so a worker's
        # tag always describes the payload it came with
        tag_self = make_deposit_tag(epoch, obs_shape[0])
        nseg = spec.n_segments
        fg_w = spec.flatten(grads, True)
        fmb_w = mb_flat
        fmask = {"w": True}
        if nseg > 1:
            fg_w, fmb_w = spec.split_payload(fg_w), spec.split_payload(fmb_w)
            fmask = {"w": (True,) * nseg}
        bundle = comm.recv_ring_inner({"w": fg_w, "tag": tag_self})

        fomb = None
        if cfg.overlap:
            fomb = {"w": sync_state["outer_mailbox"] if nseg == 1 else
                    spec.split_payload(sync_state["outer_mailbox"])}
        fsynced, fdeposit, fnew_omb = _sync_core(
            comm, cfg, {"w": fg_w}, {"w": fmb_w}, epoch, fmask,
            outer_mb=fomb, ship_due=ship_now, deposit={"w": bundle["w"]})
        synced = spec.unflatten(spec.join_payload(fsynced["w"]) if nseg > 1
                                else fsynced["w"], grads, True)
        deposit_w = spec.join_payload(fdeposit["w"]) if nseg > 1 \
            else fdeposit["w"]
        new_omb = sync_state["outer_mailbox"]
        if fnew_omb is not None:
            new_omb = spec.join_payload(fnew_omb["w"]) if nseg > 1 \
                else fnew_omb["w"]

        # -- slot e % k_max takes the deposit and its tag, out of place
        # (stored flat: the buffer does not depend on chunking)
        slot_w = (epoch % k_max).reshape(1).to(torch.int64)
        new_payload = payload.index_copy(
            1, slot_w, deposit_w.unsqueeze(1).to(payload.dtype))
        new_tags = tags.index_copy(1, slot_w, bundle["tag"].unsqueeze(1))
        row = None
        if with_obs:
            shipped = ship_now if cfg.overlap else torch.zeros(
                (), dtype=torch.bool, device=dev)
            row = {
                "k_eff": new_k.expand(obs_shape).to(torch.int32),
                "skew_ema": new_ctrl["skew_ema"],
                "deposit_age": observed,
                "shipped": shipped.expand(obs_shape).to(torch.int32),
            }
        return synced, {
            "mailbox": {"payload": new_payload, "tag": new_tags},
            "outer_mailbox": new_omb,
            "ctrl": new_ctrl,
        }, row


def make_schedule(cfg: SyncConfig, mask, spec: FusionSpec) -> SyncSchedule:
    """The schedule of `cfg`: `AdaptiveSchedule` under `cfg.adaptive`,
    else `StaticSchedule` (sync or overlap, at any RMA depth)."""
    cls = AdaptiveSchedule if cfg.adaptive else StaticSchedule
    return cls(cfg, mask, spec)
