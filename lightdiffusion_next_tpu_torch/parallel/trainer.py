"""The flow-matching train step of the Flux DiT, over a ("data", "model")
mesh, with its checkpoints.

Counterpart of lightdiffusion_next_tpu/parallel/trainer.py, with its names
and call shapes: ``flow_matching_loss``, ``make_train_step``,
``build_sharded_trainer``, ``save_checkpoint``, ``restore_checkpoint``.
Input batches come through ``parallel.data.prefetch_to_mesh``.

Where each JAX piece went:

- ``jax.value_and_grad`` of the GSPMD forward -> ``loss.backward()`` of
  the port's explicit tensor-parallel forward (``parallel.spmd``), whose
  collectives are Megatron's conjugate pair (``parallel.mesh``): each
  row-parallel sum all-reduces forward, each column-parallel input and
  QKNorm scale all-reduces its gradient backward;
- the batch sharded over "data" and XLA's psum of the gradients -> each
  rank's rows of the batch (``inference.shard_batch``) and a mean
  all-reduce of every gradient over the "data" group; the loss returned is
  that mean too;
- ``optax.adamw(1e-4)`` -> ``torch.optim.AdamW`` set to its arithmetic
  (``AdamW``: weight decay 1e-4 on every leaf, where torch's default is
  0.01); the optimizer is the port's ``opt_state``, its per-leaf state
  optax's ``mu`` (``exp_avg``), ``nu`` (``exp_avg_sq``) and ``count``
  (``step``);
- ``jax.checkpoint`` of the scan bodies (``remat``) ->
  ``FluxConfig.remat_blocks`` (``torch.utils.checkpoint``);
- orbax -> ``torch.distributed.checkpoint`` (``save_checkpoint``);
- ``donate_argnums`` -> the step updates the params in place.

The step runs its forward and backward under ``attention_backend="sdpa"``
(the port's name for JAX's "xla"), the caller's ``RuntimeConfig`` restored
after: no hand-written kernel has a backward, in either package
(``ops.grad_guard``). Every run of the JAX trainer in the repository stays
under the 512 tokens from which its attention would take the Pallas
kernel, which ``jax.grad`` cannot differentiate. The params are dense f32,
as JAX's (``init_params(..., dtype=float32)``), so no quantized kernel is
reached either.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
import torch.distributed as dist

from lightdiffusion_next_tpu_torch import config as _config
from lightdiffusion_next_tpu_torch.models import flux as flux_mod
from lightdiffusion_next_tpu_torch.parallel import inference, layout, spmd
from lightdiffusion_next_tpu_torch.parallel import mesh as mesh_mod
from lightdiffusion_next_tpu_torch.parallel import sharding as shard_rules

BATCH_KEYS = ("latent", "noise", "t", "context", "y", "guidance")


def flow_matching_loss(params, batch, cfg: flux_mod.FluxConfig):
    """Rectified-flow objective: x_t = (1-t) x1 + t x0, target v = x0 - x1,
    the mean squared error of the prediction in f32."""
    x1, x0, t, ctx, y, guidance = (batch[k] for k in BATCH_KEYS)
    tb = t[:, None, None, None]
    xt = (1.0 - tb) * x1 + tb * x0
    target = x0 - x1
    pred = flux_mod.apply_flux(params, xt, t, ctx, y, guidance=guidance, cfg=cfg)
    return torch.mean((pred.float() - target) ** 2)


def leaves(params: Dict) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every leaf, in the dict's order; a stacked
    family's leaves as "<stack key>/<key>"."""
    for key, leaf in params.items():
        if isinstance(leaf, dict):
            for rel, t in leaf.items():
                yield f"{key}/{rel}", t
        else:
            yield key, leaf


def _spec(name: str) -> tuple:
    stack, _, rel = name.partition("/")
    return shard_rules.flux_param_spec(spmd._stack_rep_key(stack, rel) if rel else name)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``optax.adamw``'s defaults and arithmetic on ``torch.optim.AdamW``:
    the weight decay applies to every leaf, decoupled from the moments, as
    optax's ``add_decayed_weights`` does."""

    learning_rate: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def init(self, params: Dict) -> torch.optim.AdamW:
        """The optimizer over ``params``' leaves, its state made at once
        (zero moments, count 0), as ``optax`` makes it."""
        ts = [t for _, t in leaves(params)]
        opt = torch.optim.AdamW(ts, lr=self.learning_rate, betas=(self.b1, self.b2),
                                eps=self.eps, weight_decay=self.weight_decay)
        for t in ts:
            opt.state[t] = {"step": torch.tensor(0.0), "exp_avg": torch.zeros_like(t),
                            "exp_avg_sq": torch.zeros_like(t)}
        return opt


def _axis(mesh, name: str):
    """(size, group) of the mesh's ``name`` axis; (1, None) without a mesh."""
    if mesh is None:
        return 1, None
    return mesh.size(mesh.mesh_dim_names.index(name)), mesh.get_group(name)


def make_train_step(cfg: flux_mod.FluxConfig, optimizer=None, mesh=None):
    """(optimizer, ``train_step(params, opt_state, batch) -> (params,
    opt_state, loss)``) for ``cfg`` (a rank's, with its ``tp_axis``, under
    tensor parallelism) on ``mesh`` (None: 1x1). The step zeroes the
    gradients, runs forward and backward under ``attention_backend="sdpa"``
    (see the module's docstring),
    mean-reduces every gradient over the mesh's "data" axis, and steps the
    optimizer, which updates ``params`` in place. Each leaf's ``.grad``
    keeps the step's gradient until the next step. ``loss`` is the batch's
    loss, averaged over "data"."""
    optimizer = optimizer or AdamW()
    n_data, data_group = _axis(mesh, "data")

    def train_step(params, opt_state, batch):
        saved = _config.get_config()
        _config.set_config(dataclasses.replace(saved, attention_backend="sdpa"))
        try:
            opt_state.zero_grad(set_to_none=True)
            loss = flow_matching_loss(params, batch, cfg)
            loss.backward()
        finally:
            _config.set_config(saved)
        loss = loss.detach()
        for _, t in leaves(params):
            if t.grad is None:  # optax decays and moves every leaf
                t.grad = torch.zeros_like(t)
            if n_data > 1:
                dist.all_reduce(t.grad, group=data_group)
                t.grad.div_(n_data)
        if n_data > 1:
            dist.all_reduce(loss, group=data_group)
            loss = loss / n_data
        opt_state.step()
        return params, opt_state, loss

    return optimizer, train_step


def _local(flat: Dict, cfg: flux_mod.FluxConfig, mesh, device, scan_blocks: bool):
    """A flat checkpoint-layout dict (numpy arrays or tensors) as this
    rank's f32 leaves on ``device``: under "model" > 1 laid out
    (``layout.to_tp_layout``) and cut (``sharding.shard_params``); stacked
    when ``scan_blocks``. Returns (params, the rank's cfg)."""
    flat = {k: torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
            for k, v in flat.items()}
    n_model, _ = _axis(mesh, "model")
    if n_model > 1:
        flat, cfg = layout.to_tp_layout(flat, cfg)
        cfg = spmd.tp_config(cfg, mesh)
        flat = shard_rules.shard_params(flat, shard_rules.flux_param_shardings(flat), mesh)
    params = {k: torch.empty(v.shape, dtype=torch.float32, device=device).copy_(v)
              for k, v in flat.items()}
    if scan_blocks:
        params = flux_mod.stack_block_params(params, cfg)
    return params, cfg


def _trainable(params: Dict) -> Dict:
    for _, t in leaves(params):
        t.requires_grad_(True)
    return params


def build_sharded_trainer(n_data: int, n_model: int, cfg: flux_mod.FluxConfig, device=None,
                          scan_blocks: bool = False, remat: bool = False):
    """(mesh, params, opt_state, train_step, make_batch) on this rank.

    The params are ``init_params(cfg, seed=0)`` in f32 (the JAX package's
    draw). On a mesh with "model" > 1 they are laid out tensor-parallel and
    cut to this rank's slices; ``scan_blocks`` stacks them
    (``stack_block_params``) and ``remat`` (which requires it) recomputes
    the stacked blocks in the backward. The optimizer is ``AdamW()``
    (optax ``adamw(1e-4)``, the JAX trainer's). A 1x1 mesh is None: no
    process group, no collective. ``make_batch`` is ``batch_maker``'s, on
    ``device`` (default: the GPU)."""
    if remat and not scan_blocks:
        raise ValueError("remat=True requires scan_blocks=True")
    device = _config.resolve_device(device)
    mesh = None if n_data * n_model == 1 else mesh_mod.make_mesh(n_data, n_model)
    params, cfg = _local(flux_mod.init_params(cfg, seed=0), cfg, mesh, device, scan_blocks)
    cfg = dataclasses.replace(cfg, remat_blocks=remat)
    optimizer, step = make_train_step(cfg, mesh=mesh)
    params = _trainable(params)
    return mesh, params, optimizer.init(params), step, batch_maker(cfg, mesh, device)


def batch_maker(cfg: flux_mod.FluxConfig, mesh, device):
    """``make_batch(batch_size, h, w, txt_len, seed=0)``: a batch drawn
    with numpy in the JAX package's order, this rank's "data" rows of it on
    ``device``."""

    def make_batch(batch_size: int, h: int, w: int, txt_len: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        batch = {
            "latent": rng.standard_normal((batch_size, h, w, cfg.in_channels)),
            "noise": rng.standard_normal((batch_size, h, w, cfg.in_channels)),
            "t": rng.uniform(0, 1, (batch_size,)),
            "context": rng.standard_normal((batch_size, txt_len, cfg.context_in_dim)),
            "y": rng.standard_normal((batch_size, cfg.vec_in_dim)),
            "guidance": np.full((batch_size,), 3.5),
        }
        batch = {k: torch.from_numpy(v.astype(np.float32)) for k, v in batch.items()}
        if mesh is not None:
            batch = {k: inference.shard_batch(v, mesh) for k, v in batch.items()}
        return {k: v.to(device) for k, v in batch.items()}

    return make_batch


# ---------------------------------------------------------------------------
# A JAX train state carried into the port's
# ---------------------------------------------------------------------------


def _unstacked(params: Dict) -> Dict:
    """A flat dict of a JAX param dict, its stacks (scan layout) split into
    the per-block keys."""
    heads = {flux_mod.DOUBLE_STACK_KEY: "double_blocks", flux_mod.SINGLE_STACK_KEY:
             "single_blocks"}
    out = {}
    for key, leaf in params.items():
        if key in heads:
            for rel, arr in leaf.items():
                arr = np.asarray(arr)
                out.update({f"{heads[key]}.{i}.{rel}": arr[i] for i in range(arr.shape[0])})
        else:
            out[key] = np.asarray(leaf)
    return out


def _adam_state(opt_state):
    """The element of an optax state that holds ``mu``, ``nu`` and
    ``count`` (``ScaleByAdamState``; ``adamw``'s is the first of its
    chain)."""
    if hasattr(opt_state, "mu"):
        return opt_state
    for s in opt_state:
        found = _adam_state(s) if isinstance(s, tuple) or hasattr(s, "mu") else None
        if found is not None:
            return found
    return None


def from_jax_state(params: Dict, opt_state, step: int, cfg: flux_mod.FluxConfig, mesh=None,
                   device=None):
    """A JAX trainer's state (its params, optax ``adamw`` state and step,
    as numpy-convertible arrays) as the port's (params, opt_state, step) on
    this rank: the params, ``mu`` and ``nu`` laid out and cut as
    ``build_sharded_trainer`` lays out and cuts the params on ``mesh``,
    stacked when the JAX params are, ``count`` as each leaf's step. The
    step functions of ``build_sharded_trainer`` on the same mesh and layout
    take it."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("opt_state holds no adam state (mu, nu, count)")
    device = _config.resolve_device(device)
    stacked = flux_mod.is_stacked(params)

    def local(tree):
        return _local(_unstacked(tree), cfg, mesh, device, stacked)[0]

    out = _trainable(local(params))
    opt = AdamW().init(out)
    count = float(np.asarray(adam.count))
    for (_, t), (_, mu), (_, nu) in zip(leaves(out), leaves(local(adam.mu)),
                                        leaves(local(adam.nu))):
        opt.state[t] = {"step": torch.tensor(count), "exp_avg": mu, "exp_avg_sq": nu}
    return out, opt, int(step)


# ---------------------------------------------------------------------------
# Checkpoints (torch.distributed.checkpoint)
# ---------------------------------------------------------------------------


def _mesh_shape(mesh) -> list:
    return [1, 1] if mesh is None else [mesh.size(0), mesh.size(1)]


def _train_state(params: Dict, opt_state, step: int, mesh) -> Dict:
    """The flat state dict ``torch.distributed.checkpoint`` writes: every
    leaf's param, ``mu`` and ``nu`` under "<part>/<name>", a leaf cut over
    "model" with "@model<r>of<n>" after its name, so that each rank's slice
    has a key of its own (the planner keeps one copy of equal keys across
    ranks: the replicated leaves and the "data" replicas); the moments'
    count, the step and the mesh's shape."""
    if mesh is None and dist.is_initialized() and dist.get_world_size() > 1:
        raise ValueError("pass the trainer's mesh: its ranks' slices are named by it")
    n_model = _axis(mesh, "model")[0]
    suffix = "" if n_model == 1 else f"@model{mesh_mod.model_rank(mesh)}of{n_model}"
    state = {}
    count = None
    for name, t in leaves(params):
        key = name + (suffix if "model" in _spec(name) else "")
        s = opt_state.state[t]
        state["params/" + key] = t.detach()
        state["mu/" + key] = s["exp_avg"]
        state["nu/" + key] = s["exp_avg_sq"]
        count = s["step"]
    state["count"] = count
    state["step"] = int(step)
    state["mesh"] = _mesh_shape(mesh)
    return state


def save_checkpoint(path: str, params: Dict, opt_state, step: int, mesh=None) -> None:
    """Write the train state (``build_sharded_trainer``'s, on its ``mesh``;
    None for 1x1) under the directory ``path``, every rank of the process
    group taking part: each replicated leaf is written once, each slice of
    a leaf cut over "model" once, by a rank that holds it."""
    import torch.distributed.checkpoint as dcp

    dcp.save(_train_state(params, opt_state, step, mesh),
             checkpoint_id=os.path.abspath(path))


def restore_checkpoint(path: str, params: Dict, opt_state, mesh=None) -> Tuple:
    """Read (params, opt_state, step) from ``path`` INTO ``params`` and
    ``opt_state`` (a freshly built trainer's on the same mesh as the saved
    one, which is checked), each rank reading only its own slices."""
    import torch.distributed.checkpoint as dcp

    state = _train_state(params, opt_state, 0, mesh)
    state["mesh"] = None
    dcp.load(state, checkpoint_id=os.path.abspath(path))
    if state["mesh"] != _mesh_shape(mesh):
        raise ValueError(f"the checkpoint was written on a {state['mesh']} mesh, not "
                         f"{_mesh_shape(mesh)}")
    for _, t in leaves(params):
        opt_state.state[t]["step"].copy_(state["count"])
    return params, opt_state, state["step"]
