"""Train step of the port: loss -> gradients -> (compression) -> AdamW,
with microbatch accumulation and the remat policy of a :class:`Plan`,
on one device or on a mesh.

Counterpart of the reference package's ``train/step.py``.
``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)`` over the state ``{"params", "opt": {"m", "v", "count"},
"step"}`` (plus ``"grad_err"`` with ``plan.compress_grads``) that
``init_train_state`` builds; the metrics carry the reference's names
(``loss``, ``ce``, ``aux``, ``tokens``, ``lr``, ``grad_norm``).  The step
updates the state in place (the reference's donation);
:func:`keep_input_state` gives the step that leaves the caller's state
intact (the reference's step jitted without donation).

With ``mesh`` (a :class:`~repro_torch.launch.mesh.Mesh`), each rank
holds its block of every leaf (``make_train_artifacts`` gives the
layouts; :func:`shard_batch` its rows of a global batch) and the step
makes, where the reference leaves it to GSPMD:

  * the ZeRO-3 gather, one layer at a time (``parallel/fsdp.py``): each
    layer's slices of the stacked leaves gathered inside that layer's
    function (again in its recompute under remat), a leaf without a
    ``layers`` dim at its first use, over the axes its layout names
    except the dims the compute keeps split over ``model``
    (``tensor.kept_dim``: the heads of ``wq``, ``bq`` and ``wo`` when
    attention is split by heads, the hidden dim of the MLP, the SSM's
    channels, the vocab of ``embed`` and ``lm_head``; the expert-parallel
    MoE's experts dim);
  * the split over ``model`` (``parallel/tensor.py``), installed for the
    forward and backward: each rank computes its heads (or, under
    ``seq_shard_attn``, its query rows), its MLP columns and its vocab
    block, and the gradient of every leaf a split region reads but holds
    alike over ``model`` (``Split.partial``: ``wk``, ``wv`` and their
    biases; every attention weight under the sequence split) is summed
    over ``model`` with the data axes;
  * the loss over the global batch: the token count summed over the
    data axes before the division, the MoE aux loss the global batch's;
  * the reduction of each gathered leaf's gradient in the gather's
    backward, as the layer's backward runs: a reduce-scatter over the
    data axes where the layout splits a dim over them, else an
    all-reduce, and this rank's block of the rest (no whole-shaped
    gradient of a stacked leaf exists; microbatches' reduced blocks are
    accumulated);
  * error-feedback compression of the reduced gradient with ``grad_err``
    laid out like the parameters (blocks of the global last axis: a leaf
    whose last dim is split off the 256-element blocks is gathered along
    it for the compression);
  * the global gradient norm for the clip: each rank's squared blocks
    summed over the mesh, a leaf held alike by several ranks counted
    once; then AdamW on the local blocks.

On a mesh of one rank no gathering is installed, the split splits
nothing, and the step computes the unsharded step's bits.  The dense
and MoE decoders, the VLM, the encoder-decoder and the hybrid are split
over ``model`` (the MoE layer itself as before: ``scatter`` on the
gathered leaves, ``shard_map`` on its tokens); the families in
``GATHER_AND_REPEAT`` (the xLSTM) gather every leaf a layer at a time and
each ``model`` rank repeats their data shard's forward and backward.
Norms and residuals are not split over the sequence (no sequence
parallelism).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.models import moe as moe_mod
from repro_torch.models.api import Model
from repro_torch.parallel import collectives, fsdp, tensor
from repro_torch.parallel.sharding import (Plan, Sharding, batch_specs,
                                           make_param_shardings, replicated)
from repro_torch.train import compression
from repro_torch.train.optimizer import (OptimizerConfig, adamw_init,
                                         adamw_update)
from repro_torch.tree import Tree, flatten, leaves, tree_map, unflatten


def init_train_state(model: Model, seed: int, opt_cfg: OptimizerConfig,
                     plan: Optional[Plan] = None) -> Dict[str, Any]:
    """The whole train state (each leaf global; ``shard_tree`` with the
    artifacts' ``state_shardings`` gives a rank's blocks)."""
    params = model.init(seed)
    state = {"params": params, "opt": adamw_init(params, opt_cfg),
             "step": torch.zeros((), dtype=torch.int32, device=model.device)}
    if plan is not None and plan.compress_grads:
        state["grad_err"] = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
    return state


def _check_plan(plan: Plan) -> None:
    assert plan.moe_impl in ("scatter", "shard_map"), plan.moe_impl
    if plan.attn_impl not in ("xla", "tri"):
        raise ValueError(f"attn_impl must be xla or tri (both run K1); got "
                         f"{plan.attn_impl!r}")


def _dp_axes(mesh, plan: Plan) -> Tuple[str, ...]:
    return tuple(a for a in plan.dp_axes if a in mesh.shape)


# the families whose compute is not split over ``model``: each ``model``
# rank repeats its data shard's forward and backward with every leaf
# gathered (ROADMAP queue 1, "tensor and context parallelism")
GATHER_AND_REPEAT = ("ssm",)


class _Layout:
    """The parameters' layouts on a mesh, in the params tree's leaf
    order, and what the step does with each leaf's gradient.
    ``experts``: keep the routed experts' experts dim split over
    ``model`` where the layout puts it there (the serving layout,
    ``serve/sharded.py``; the train step gathers them whole)."""

    def __init__(self, model: Model, mesh, plan: Plan,
                 experts: bool = False):
        specs, axes = model.param_specs()
        self.tree = make_param_shardings(mesh, axes, specs, plan)
        self.paths = [k for k, _ in flatten(self.tree)]
        self.names = [k.rsplit("/", 1)[-1] for k in self.paths]
        self.flat: List[Sharding] = leaves(self.tree)
        self.mesh = mesh
        self.cfg, self.plan = model.cfg, plan
        self.dp = _dp_axes(mesh, plan)
        self.m = mesh.shape.get(tensor.AXIS, 1)
        self.tp = tensor.AXIS in mesh.shape \
            and model.cfg.family not in GATHER_AND_REPEAT
        heads = self.tp and tensor.heads_split(model.cfg, plan, self.m)
        ep = plan.moe_impl == "shard_map"
        axes_flat = dict(flatten(axes))
        self.keep = []  # dims kept local for the compute
        self.kept = []  # whether a split region keeps the leaf split
        self.regions = set()  # the regions whose dims are kept split
        split_all = set()  # those whose dims some leaf keeps whole
        for path, name, sh in zip(self.paths, self.names, self.flat):
            keep = ()
            if ep and name in moe_mod.EXPERT_LEAVES:
                d = axes_flat[path].index("experts")
                entry = sh.spec[d]
                if not set(entry) <= {"model"} or mesh.size(entry) != self.m:
                    raise ValueError(f"{path}: experts dim laid out over "
                                     f"{entry}, not over model ({self.m})")
                keep = (d,)
            d = None
            if self.tp and self.m > 1:
                d = tensor.kept_dim(name, axes_flat[path], sh.spec, heads,
                                    experts)
                region = tensor.region_of(name)
                if d is not None:
                    keep = (d,)
                    self.regions.add(region)
                elif region and tensor.REGIONS[region][1] in axes_flat[path]:
                    split_all.add(region)
            self.keep.append(keep)
            self.kept.append(d is not None)
        if self.regions & split_all:
            raise ValueError(f"regions {sorted(self.regions & split_all)}: "
                             f"some leaves split over model, some whole")

    def split(self, seq_len: int) -> Optional[tensor.Split]:
        """The split of a forward of ``seq_len`` positions (None for a
        family that gathers and repeats, or a mesh with no ``model``)."""
        if not self.tp:
            return None
        attn = tensor.attn_mode(self.cfg, self.plan, self.m, seq_len)
        regions = (self.regions - {"attn"}) | ({"attn"} if attn else set())
        return tensor.Split(self.mesh, attn, frozenset(regions))

    def leaf_plans(self, split: Optional[tensor.Split]
                   ) -> List[fsdp.Leaf]:
        """How each leaf is gathered and its gradient reduced in a forward
        of ``split``: over the axes its layout names, except the dims the
        compute keeps split (none for a leaf of a region ``split`` does
        not split: the serving decode's SSM heads, gathered whole); its
        gradient summed over the data axes, and over ``model`` where
        ``split`` leaves it partial (an encoder attention leaf at the
        encoder's frames)."""
        out = []
        for path, name, sh, keep, kept in zip(
                self.paths, self.names, self.flat, self.keep, self.kept):
            if kept and not split.splits(tensor.region_of(name)):
                keep, kept = (), False
            seq = self.cfg.encoder_frames \
                if path.startswith("enc_blocks/") else None
            partial = split is not None and split.partial(name, kept, seq)
            out.append(fsdp.Leaf(self.mesh, sh.spec, keep, self.dp + (
                (tensor.AXIS,) if partial else ())))
        return out

    def global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """sqrt of the sum of squares of the global gradient: each rank's
        blocks' sums, counted on the one rank at coordinate 0 of every
        axis that holds the leaf alike, summed over the mesh."""
        sums = []
        for g, sh in zip(grads, self.flat):
            s = torch.sum(torch.square(g.float()))
            used = {a for e in sh.spec for a in e}
            if any(self.mesh.coord(a) for a in self.mesh.shape
                   if a not in used):
                s = torch.zeros_like(s)
            sums.append(s)
        sums = collectives.all_reduce(torch.stack(sums), self.mesh,
                                      tuple(self.mesh.shape))
        return torch.sqrt(torch.sum(sums))

    def compress(self, grads: List[torch.Tensor], errs: List[torch.Tensor]
                 ) -> None:
        """Error-feedback compression of each local gradient in place,
        in the global leaf's blocks of the last axis."""
        for g, e, sh in zip(grads, errs, self.flat):
            last = sh.spec[-1] if sh.spec else ()
            n = self.mesh.size(last)
            width = sh.shape[-1] // n if sh.shape else 1
            if n == 1 or (width % compression.BLOCK == 0
                          and sh.shape[-1] >= compression.BLOCK):
                compression.compress_(g, e)
                continue
            d = len(sh.shape) - 1
            gf = collectives.all_gather_dim(g, d, self.mesh, last)
            ef = collectives.all_gather_dim(e, d, self.mesh, last)
            compression.compress_(gf, ef)
            g.copy_(collectives.slice_block(gf, d, self.mesh, last))
            e.copy_(collectives.slice_block(ef, d, self.mesh, last))


def _like(tree: Tree, flat) -> Tree:
    """``flat`` (leaves in ``tree``'s order) in ``tree``'s structure."""
    return unflatten((path, x) for (path, _), x in zip(flatten(tree), flat))


def make_grad_fn(model: Model, plan: Plan, mesh=None,
                 layout: Optional[_Layout] = None) -> Callable:
    """``grad_fn(params, batch) -> (loss, metrics, grads)``: the step's
    forward and backward, microbatches accumulated; on a mesh over this
    rank's blocks of the parameters and rows of the batch, the metrics
    the global batch's and ``grads`` this rank's blocks of the reduced
    gradient (each microbatch's reduced as its backward runs, one layer
    at a time: ``parallel/fsdp.py``).  The metrics are the last
    microbatch's, as the reference's."""
    _check_plan(plan)
    nm = plan.microbatch
    if mesh is not None and layout is None:
        layout = _Layout(model, mesh, plan)
    dp = () if mesh is None else layout.dp
    # a mesh of one rank gathers and reduces nothing: no gathering
    gathers = mesh is not None and mesh.size(tuple(mesh.shape)) > 1
    aux_in_loss = not model.cfg.is_encoder_decoder  # as the loss_fns

    def one(local: List[torch.Tensor], params: Tree, batch, plans):
        for p in local:
            p.requires_grad_(True)
        gathering = fsdp.Gathering(local, plans) if plans else None
        with fsdp.installed(gathering):
            loss, metrics = model.loss(_like(params, local), batch,
                                       remat=plan.remat)
            if mesh is None:
                grads = torch.autograd.grad(loss, local)
                return (loss.detach(),
                        {k: v.detach() for k, v in metrics.items()}, grads)
            ce, aux, n = metrics["ce"], metrics["aux"], metrics["tokens"]
            tokens = collectives.all_reduce(
                n.detach().float().reshape(1).clone(), mesh, dp)[0]
            scalar = loss
            if mesh.size(dp) > 1:  # this rank's share of the global mean
                share = n / tokens
                scalar = ce * share + aux if aux_in_loss else ce * share
                ce = ce.detach() * share
            grads = torch.autograd.grad(scalar, local)
        ce = collectives.all_reduce(ce.detach().reshape(1).clone(), mesh,
                                    dp)[0]
        aux = aux.detach()
        loss = ce + aux if aux_in_loss else ce
        return loss, {"loss": loss, "ce": ce, "aux": aux,
                      "tokens": tokens}, grads

    def grad_fn(params: Tree, batch: Dict[str, torch.Tensor]):
        local = leaves(params)
        impl = plan.moe_impl if mesh is not None else "scatter"
        split = None if layout is None \
            else layout.split(batch["tokens"].shape[1])
        plans = layout.leaf_plans(split) if gathers else None
        with moe_mod.moe_impl(impl, mesh, plan.dp_axes), \
                tensor.split(split):
            if nm <= 1:
                return one(local, params, batch, plans)
            B = batch["tokens"].shape[0]
            if B % nm:
                raise ValueError(f"batch {B} is not a multiple of "
                                 f"microbatch {nm}")
            acc = [torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device) for p in local]
            total = 0.0
            for i in range(nm):
                mb = {k: v[i * (B // nm):(i + 1) * (B // nm)]
                      for k, v in batch.items()}
                loss, metrics, grads = one(local, params, mb, plans)
                for a, g in zip(acc, grads):
                    a.add_(g.float() / nm)
                total = total + loss / nm
                del grads
        return total, metrics, acc

    return grad_fn


def make_train_step(model: Model, opt_cfg: OptimizerConfig, plan: Plan,
                    mesh=None) -> Callable:
    """The train step of ``plan`` (on ``mesh``'s ranks when given; the
    MoE as ``plan.moe_impl`` there, the scatter path without a mesh, as
    in the reference)."""
    layout = None if mesh is None else _Layout(model, mesh, plan)
    grad_fn = make_grad_fn(model, plan, mesh, layout)

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
        params = state["params"]
        _, metrics, grads = grad_fn(params, batch)
        grads = list(grads)
        if plan.compress_grads:
            errs = leaves(state["grad_err"])
            if layout is None:
                for g, e in zip(grads, errs):
                    compression.compress_(g, e)
            else:
                layout.compress(grads, errs)
        gnorm = None if layout is None else layout.global_norm(grads)
        grad_tree = _like(params, grads)
        del grads
        _, _, opt_metrics = adamw_update(grad_tree, state["opt"], params,
                                         opt_cfg, gnorm=gnorm)
        del grad_tree
        state["step"].add_(1)
        return state, {**metrics, **opt_metrics}

    return train_step


def shard_batch(batch: Dict[str, torch.Tensor], mesh, plan: Plan
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch: its block of each microbatch
    (microbatch ``i`` is rows ``i·B/nm ..`` of the global batch, as the
    reference splits it, each split over the data axes); the batch
    itself on one data rank."""
    dp = _dp_axes(mesh, plan)
    n = mesh.size(dp)
    if n == 1:
        return batch
    nm = max(plan.microbatch, 1)
    B = batch["tokens"].shape[0]
    if B % (n * nm):
        raise ValueError(f"batch {B} does not split over {n} data ranks "
                         f"and {nm} microbatches")
    b, r = B // (n * nm), mesh.index(dp)
    return {k: torch.cat([v[i * (B // nm) + r * b:i * (B // nm)
                            + (r + 1) * b] for i in range(nm)])
            for k, v in batch.items()}


def keep_input_state(step_fn: Callable) -> Callable:
    """The step on a copy of the state, so the caller's state is left as
    it was: the reference's train step jitted without donation."""

    def step(state, batch):
        copy = tree_map(lambda x: x.detach().clone(), state)
        return step_fn(copy, batch)

    return step


@dataclasses.dataclass
class TrainArtifacts:
    step_fn: Callable
    state_specs: Tree
    state_shardings: Tree
    batch_input_specs: Tree
    batch_shardings: Tree


def state_layouts(model: Model, mesh, plan: Plan,
                  compress: bool) -> Tree:
    """The :class:`Sharding` tree of a train state: parameters, moments
    and ``grad_err`` by the parameters' layouts, the counts whole."""
    specs, axes = model.param_specs()
    p_shard = make_param_shardings(mesh, axes, specs, plan)
    rep = replicated(mesh)
    out = {"params": p_shard,
           "opt": {"m": p_shard, "v": p_shard, "count": rep},
           "step": rep}
    if compress:
        out["grad_err"] = p_shard
    return out


def make_train_artifacts(model: Model, mesh, plan: Plan,
                         opt_cfg: OptimizerConfig, shape) -> TrainArtifacts:
    """Everything a launcher needs to run the step on ``mesh``: the
    state's specs (meta tensors) and layouts, the batch's, and the step
    (the reference's ``make_train_artifacts``)."""
    param_specs, _ = model.param_specs()
    mdt = getattr(torch, opt_cfg.moment_dtype)

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    moments = tree_map(lambda s: meta(s.shape, mdt), param_specs)
    state_specs = {"params": param_specs,
                   "opt": {"m": moments, "v": tree_map(lambda x: x, moments),
                           "count": meta((), torch.int32)},
                   "step": meta((), torch.int32)}
    if plan.compress_grads:
        state_specs["grad_err"] = tree_map(
            lambda s: meta(s.shape, torch.float32), param_specs)
    b_specs = model.input_specs(shape)
    return TrainArtifacts(
        make_train_step(model, opt_cfg, plan, mesh), state_specs,
        state_layouts(model, mesh, plan, plan.compress_grads), b_specs,
        batch_specs(b_specs, mesh, plan))
