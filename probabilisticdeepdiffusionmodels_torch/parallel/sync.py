"""The train state's collectives on a mesh: data parallelism, FSDP and the
gradient side of tensor parallelism.

JAX's engine places its state on the mesh and XLA inserts the gradient
all-reduce (or, with ``param_sharding="fsdp"``, the all-gathers and
reduce-scatters).  Here :class:`MeshSync` does it by hand, on flat buckets
so a step makes one collective of each kind:

  * ``"replicated"``: every rank holds the whole state.  After the backward
    the gradients (each rank's share of the global loss, see
    ``parallel.mesh.batch_mean``) and the loss shares are summed over the
    ranks by one ``all_reduce``; the optimizer and the EMA then make the same
    update on every rank.
  * ``"fsdp"``: every parameter of ``fsdp_min_size`` elements or more that
    ``fsdp_sharding`` splits keeps only this rank's contiguous 1/N block
    along the chosen dim, as a "master" tensor: the parameters themselves,
    their EMA copies and their Adam moments (the optimizer runs over the
    masters).  The modules' own parameters are working copies: a forward
    (a pre-hook on the module) or ``materialize`` all-gathers them from the
    masters, and ``release`` frees their storage after each update.  The
    sharded gradients are reduce-scattered to the masters, the replicated
    ones all-reduced; the global gradient norm sums the shards' squares
    over the ranks.
  * ``"tp"`` (on a data x model mesh): the modules hold this rank's slices
    of the leaves ``tp_sharding`` splits over the model axis
    (``parallel.tp.shard_model``), and so do the EMA and Adam's moments.
    Every gradient is all-reduced over the DATA group only (a model rank's
    data group holds its own slices); the global norm sums the squares of
    the split leaves over the model group and adds the replicated ones
    once.  A checkpoint gathers the slices whole, as FSDP's.

Every collective is made by every rank in the same order: the steps, the
endpoints and the checkpoint saves that reach them run on all ranks.  The
state starts the same everywhere: rank 0's weights are broadcast.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, MODEL_AXIS, fsdp_sharding, mesh_axis
from .tp import tp_slice

__all__ = ["MeshSync"]


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _split_into(flat: torch.Tensor, outs: Sequence[torch.Tensor]) -> None:
    off = 0
    for o in outs:
        n = o.numel()
        o.copy_(flat[off:off + n].view_as(o))
        off += n


class MeshSync:
    """Collectives of one train state over ``mesh``'s data axis; see the
    module docstring.  ``model`` and ``ema_model`` (or None) are the state's
    modules; the optimizer is built over :meth:`optimizer_params`."""

    def __init__(self, mesh, model: torch.nn.Module, ema_model: Optional[torch.nn.Module],
                 mode: str = "replicated", min_size: int = 65536,
                 tp_dims: Optional[Dict[str, Optional[int]]] = None):
        if mode not in ("replicated", "fsdp", "tp"):
            raise ValueError(f"MeshSync mode {mode!r} (replicated | fsdp | tp)")
        if (mode == "tp") != (tp_dims is not None):
            raise ValueError('MeshSync takes tp_dims (parallel.tp.shard_model) with mode "tp" '
                             "and only then")
        self.mesh, self.mode = mesh, mode
        self.index, self.size, self.group = mesh_axis(mesh, DATA_AXIS)
        self.model_index, self.model_size, self.model_group = (
            mesh_axis(mesh, MODEL_AXIS) if MODEL_AXIS in mesh.mesh_dim_names else (0, 1, None))
        self.src = dist.get_global_rank(self.group, 0)
        self.names = [n for n, _ in model.named_parameters()]
        # each parameter's axis split over the model axis (tp), else None
        self.tp_dims: List[Optional[int]] = [(tp_dims or {}).get(n) for n in self.names]
        self.modules = {"model": model, "ema": ema_model}
        self._broadcast([p for m in self.modules.values() if m is not None
                         for p in m.parameters()])
        self.dims: List[Optional[int]] = [None] * len(self.names)
        self.masters: Dict[str, List[torch.Tensor]] = {}
        self.materialized = {"model": True, "ema": ema_model is not None}
        if mode == "fsdp":
            layout = fsdp_sharding(mesh, model, min_size=min_size)
            axis = mesh.mesh_dim_names.index(DATA_AXIS)
            for i, name in enumerate(self.names):
                placement = layout[name][axis]
                self.dims[i] = placement.dim if placement.is_shard() else None
            for which, module in self.modules.items():
                if module is None:
                    continue
                self.masters[which] = [
                    p if d is None else torch.nn.Parameter(self._block(p.detach(), d).clone(),
                                                           requires_grad=p.requires_grad)
                    for p, d in zip(module.parameters(), self.dims)]
                module.register_forward_pre_hook(
                    lambda mod, args, which=which: self.materialize(which))
            self.release()

    # ------------------------------------------------------------ layout

    @property
    def sharded(self) -> bool:
        """Whether the optimizer runs over FSDP masters."""
        return self.mode == "fsdp"

    @property
    def splits(self) -> bool:
        """Whether some leaves are split over ranks, so the global gradient
        norm needs a collective (``grad_norms``)."""
        return self.mode in ("fsdp", "tp")

    @property
    def is_main(self) -> bool:
        """Rank (0, 0) of the mesh: the one that writes."""
        return self.index == 0 and self.model_index == 0

    def _block(self, full: torch.Tensor, d: int) -> torch.Tensor:
        k = full.shape[d] // self.size
        return full.narrow(d, self.index * k, k)

    def _sharded_indices(self) -> List[int]:
        return [i for i, d in enumerate(self.dims) if d is not None]

    def optimizer_params(self, model: torch.nn.Module) -> List[torch.Tensor]:
        """What the optimizer updates: the masters under FSDP, else the
        model's parameters."""
        return self.masters["model"] if self.sharded else list(model.parameters())

    def ema_pairs(self) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """(EMA tensors, live tensors) that the EMA update reads and writes."""
        if self.sharded:
            return self.masters["ema"], self.masters["model"]
        return (list(self.modules["ema"].parameters()),
                list(self.modules["model"].parameters()))

    # ------------------------------------------------------------ collectives

    def _broadcast(self, tensors: List[torch.Tensor]) -> None:
        if not tensors:
            return
        with torch.no_grad():
            flat = _flat(tensors)
            dist.broadcast(flat, src=self.src, group=self.group)
            _split_into(flat, tensors)

    def _gather(self, shards: List[torch.Tensor], dims: List[int],
                outs: List[torch.Tensor], model_axis: bool = False) -> None:
        """All-gather each shard along its dim into ``outs`` (one collective),
        over the data group or, with ``model_axis``, the model group."""
        size, group = ((self.model_size, self.model_group) if model_axis
                       else (self.size, self.group))
        moved = [s.movedim(d, 0) for s, d in zip(shards, dims)]
        send = _flat(moved)
        recv = torch.empty(size * send.numel(), dtype=send.dtype, device=send.device)
        dist.all_gather_into_tensor(recv, send, group=group)
        recv = recv.view(size, send.numel())
        off = 0
        for m, d, out in zip(moved, dims, outs):
            n = m.numel()
            full = recv[:, off:off + n].reshape(size * m.shape[0], *m.shape[1:])
            out.copy_(full.movedim(0, d))
            off += n

    def _tp_indices(self) -> List[int]:
        return [i for i, d in enumerate(self.tp_dims) if d is not None]

    def _tp_whole(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Per-parameter tensors in the tp layout gathered whole over the
        model group; the replicated ones as they are."""
        out = list(tensors)
        idx = self._tp_indices()
        if not idx:
            return out
        fulls = []
        for i in idx:
            shape = list(tensors[i].shape)
            shape[self.tp_dims[i]] *= self.model_size
            fulls.append(torch.empty(shape, dtype=tensors[i].dtype, device=tensors[i].device))
        self._gather([tensors[i].detach() for i in idx], [self.tp_dims[i] for i in idx], fulls,
                     model_axis=True)
        for i, f in zip(idx, fulls):
            out[i] = f
        return out

    def _tp_slice(self, full: torch.Tensor, d: Optional[int]) -> torch.Tensor:
        if d is None:
            return full
        return tp_slice(full, self.model_index, self.model_size, d).clone()

    def materialize(self, which: str = "model") -> None:
        """The module's working copy gathered from the masters (FSDP; a
        no-op when it is current or without FSDP)."""
        if not self.sharded or self.materialized[which]:
            return
        module = self.modules[which]
        params = list(module.parameters())
        idx = self._sharded_indices()
        with torch.no_grad():
            for i in idx:
                p = params[i]
                p.untyped_storage().resize_(p.numel() * p.element_size())
            self._gather([self.masters[which][i] for i in idx], [self.dims[i] for i in idx],
                         [params[i] for i in idx])
        self.materialized[which] = True

    def release(self) -> None:
        """Free the working copies of the sharded parameters (FSDP)."""
        if not self.sharded:
            return
        for which, module in self.modules.items():
            if module is None:
                continue
            params = list(module.parameters())
            for i in self._sharded_indices():
                params[i].grad = None
                params[i].untyped_storage().resize_(0)
            self.materialized[which] = False

    def reduce_gradients(self, model: torch.nn.Module,
                         scalars: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Sum the gradients (each rank's share) over the ranks: into the
        parameters' ``.grad`` (replicated) or the masters' (FSDP: the
        sharded ones reduce-scattered).  ``scalars`` (loss shares) are
        summed along; returns them."""
        params = list(model.parameters())
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        rep = [i for i, d in enumerate(self.dims) if d is None]
        with torch.no_grad():
            flat = torch.cat([_flat([grads[i] for i in rep]) if rep else grads[0].new_zeros(0),
                              torch.stack([s.detach().float().reshape(()) for s in scalars])])
            dist.all_reduce(flat, group=self.group)
            n_rep = flat.numel() - len(scalars)
            # a replicated leaf is its own master
            for i in rep:
                params[i].grad = grads[i]
            _split_into(flat[:n_rep], [grads[i] for i in rep])
            if self.sharded:
                self._reduce_scatter(grads)
        return list(flat[n_rep:].unbind(0))

    def _reduce_scatter(self, grads: List[torch.Tensor]) -> None:
        idx = self._sharded_indices()
        if not idx:
            return
        moved = [grads[i].movedim(self.dims[i], 0) for i in idx]
        # row r of the send buffer: every leaf's r-th block, flattened
        send = torch.cat([m.reshape(self.size, -1) for m in moved], dim=1).contiguous()
        recv = torch.empty(send.shape[1], dtype=send.dtype, device=send.device)
        dist.reduce_scatter_tensor(recv, send.reshape(-1), group=self.group)
        off = 0
        for i, m in zip(idx, moved):
            n = m.numel() // self.size
            block = recv[off:off + n].reshape(m.shape[0] // self.size, *m.shape[1:])
            self.masters["model"][i].grad = block.movedim(0, self.dims[i]).contiguous()
            off += n

    def grad_norms(self, grads: Sequence[Optional[torch.Tensor]],
                   groups: Optional[Sequence[int]] = None) -> torch.Tensor:
        """The float32 global L2 norm of the gradients ``grads`` of the
        optimizer's tensors (the masters under FSDP, whose shards' squares
        are summed over the ranks), or with ``groups`` (a group id per
        tensor) one norm per group id 0..G-1."""
        groups = [0] * len(grads) if groups is None else list(groups)
        n_groups = max(groups) + 1 if groups else 1
        sq = [g.float().square().sum() if g is not None else None for g in grads]
        ref = next(s for s in sq if s is not None)
        rep = torch.zeros(n_groups, dtype=torch.float32, device=ref.device)
        shard = torch.zeros_like(rep)
        for s, grp, d, td in zip(sq, groups, self.dims, self.tp_dims):
            if s is None:
                continue
            if (self.sharded and d is not None) or td is not None:
                shard[grp] += s
            else:
                rep[grp] += s
        if self.sharded:
            dist.all_reduce(shard, group=self.group)
        if self.mode == "tp":
            dist.all_reduce(shard, group=self.model_group)
        return torch.sqrt(rep + shard)

    def gather_history(self, t: torch.Tensor, losses: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(t, losses) of the global batch, in rank order: one all-gather."""
        send = torch.stack([t.to(torch.float32), losses.detach().float()])
        recv = torch.empty((self.size * 2, send.shape[1]), dtype=send.dtype, device=send.device)
        dist.all_gather_into_tensor(recv, send, group=self.group)
        recv = recv.view(self.size, 2, send.shape[1])
        return (recv[:, 0].reshape(-1).round().to(t.dtype), recv[:, 1].reshape(-1))

    def all_sum(self, values: torch.Tensor) -> torch.Tensor:
        """``values`` summed over the ranks (a new tensor)."""
        out = values.detach().clone()
        dist.all_reduce(out, group=self.group)
        return out

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` [b, ...] concatenated in rank order [N b, ...]."""
        x = x.contiguous()
        out = torch.empty((self.size * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x, group=self.group)
        return out

    def barrier(self) -> None:
        """Every rank of the mesh: the data group, then the model group."""
        dist.barrier(group=self.group)
        if self.model_group is not None:
            dist.barrier(group=self.model_group)

    # ------------------------------------------------------------ checkpoints

    def state_dict(self, which: str = "model") -> Dict[str, torch.Tensor]:
        """The module's whole (one-device) ``state_dict``: the FSDP working
        copy gathered, or the tp slices gathered over the model group (a
        collective: every rank calls it)."""
        module = self.modules[which]
        if self.sharded:
            self.materialize(which)
        state = module.state_dict()
        if self.mode != "tp":
            return state
        return dict(zip(self.names, self._tp_whole([state[n] for n in self.names])))

    def gather_moments(self, moments: List[torch.Tensor]) -> List[torch.Tensor]:
        """Per-parameter tensors in the masters' layout (Adam's moments, the
        accumulation buffer) gathered whole; replicated ones as they are."""
        if self.mode == "tp":
            return self._tp_whole(moments)
        if not self.sharded:
            return list(moments)
        model_params = list(self.modules["model"].parameters())
        out = list(moments)
        idx = self._sharded_indices()
        fulls = [torch.empty(model_params[i].shape, dtype=moments[i].dtype,
                             device=moments[i].device) for i in idx]
        self._gather([moments[i] for i in idx], [self.dims[i] for i in idx], fulls)
        for i, f in zip(idx, fulls):
            out[i] = f
        return out

    def shard_moments(self, moments: List[torch.Tensor]) -> List[torch.Tensor]:
        """Whole per-parameter tensors cut to this rank's blocks (FSDP) or
        slices (tp)."""
        if self.mode == "tp":
            return [self._tp_slice(m, d) for m, d in zip(moments, self.tp_dims)]
        if not self.sharded:
            return list(moments)
        return [m if d is None else self._block(m, d).clone()
                for m, d in zip(moments, self.dims)]

    def load_full(self, which: str, state: Dict[str, torch.Tensor]) -> None:
        """Whole parameters (a one-device ``state_dict``) into the module and,
        under FSDP, its masters; the working copy is released after."""
        module = self.modules[which]
        if self.mode == "tp":
            module.load_state_dict({n: self._tp_slice(state[n], d)
                                    for n, d in zip(self.names, self.tp_dims)})
        elif self.sharded:
            with torch.no_grad():
                for p, master, name, d in zip(module.parameters(), self.masters[which],
                                              self.names, self.dims):
                    if d is not None:
                        master.copy_(self._block(state[name].to(master.device), d))
            self.materialized[which] = False
            for i, (p, name) in enumerate(zip(module.parameters(), self.names)):
                if self.dims[i] is None:
                    with torch.no_grad():
                        p.copy_(state[name])
        else:
            module.load_state_dict(state)
