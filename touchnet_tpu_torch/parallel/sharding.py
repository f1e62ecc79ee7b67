# Copyright (c) 2026 touchnet_tpu authors.
# The parallel plan of the port's trainer: tensor parallelism, then the
# compiled blocks (--training_compile), then FSDP2 (HSDP, DDP) over the
# data-parallel ranks.
#
# Port of touchnet_tpu/parallel/sharding.py: the rule table (:33-50)
# becomes the plan apply_tp lays out, and FSDP_AXES / BATCH_AXES (:29-31)
# the meshes apply_fsdp shards over (dp_mesh_of). JAX annotates PartitionSpecs and lets GSPMD insert
# the collectives; here the parameters become DTensors on the mesh and the
# forward runs on their local shards with explicit collectives:
#   TP colwise  q/k/v and gate/up: Shard(0) on "tp" (the output features:
#               whole heads, whole MLP columns); their input enters through
#               sum_backward (identity forward, dx summed over tp);
#   TP rowwise  o/down and the touch_audio projector: Shard(1) (the input
#               features); the partial product leaves through sum_forward
#               (summed over tp, identity backward), a bias after it;
#   vocab       embed_tokens and lm_head: Shard(0) on "tp" (the vocab). The
#               embedding looks up the ids of its shard and sums over tp;
#               the head stays sharded into K3 under loss parallel
#               (parallel/loss_parallel.py) and its logits are gathered
#               over tp for the full-logits loss;
#   replicated  the norms and every other tensor: Replicate on "tp". The
#               plan shards no sequence between blocks, so the norms run on
#               the whole sequence of every tp rank.
# A dimension that tp does not divide stays replicated, as JAX's
# _shrink_spec_to_shape drops the axis (Touch-Audio's V = 1025 at tp 2,
# the projector's input width), except the attention heads: each rank's K1
# and K2 see whole local heads, so tp must divide num_key_value_heads (and
# num_attention_heads); GSPMD can split inside a head, the port cannot, and
# raises a ValueError naming the flag.
# qwen2_audio and kimi_audio have no rule table (param_rules=None in JAX):
# they get FSDP only (the trainer refuses tp, cp and pp for them).
#
# FSDP2 (fully_shard) wraps each layer of every ModuleList, then the root,
# over the flattened (dp_shard, cp) submesh (FSDP_AXES); HSDP uses the 2-D
# (dp_replicate, dp_shard x cp) mesh; DDP is that mesh with dp_shard x cp 1
# (replication over dp_replicate). reshard_after_forward follows
# --training_fsdp_reshard_after_forward (never: the gathered weights stay
# until the backward, JAX's _reshard_policy). MixedPrecisionPolicy takes the
# compute and reduce dtypes. The loss is this rank's rows over the global
# sentence count, so the data-parallel reduction must sum: the divide
# factor is set to 1 (FSDP2 divides by the group size by default).

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn


# -- collectives with their autograd ------------------------------------------

class _SumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        r = dist.get_rank(ctx.group)
        return g.chunk(n, dim=-1)[r].contiguous(), None


# A compiled block or loss (--training_compile) runs these collectives
# eagerly, between its graphs: traced into a graph over NCCL, the loss's
# _SumForward gave every gradient as zero (the card's world 1, phase 9),
# while over gloo it traced right. Without a group, or over a group of one
# rank, each is the identity, which a graph takes in without a break.
@torch.compiler.disable
def _sum_forward(x, group):
    return _SumForward.apply(x, group)


@torch.compiler.disable
def _sum_backward(x, group):
    return _SumBackward.apply(x, group)


@torch.compiler.disable
def _gather_last(x, group):
    return _GatherLast.apply(x, group)


def _alone(group) -> bool:
    return group is None or dist.get_world_size(group) == 1


def sum_forward(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over ``group``; the backward is the identity (every rank
    computes the same function of the sum). Identity without a group or
    over one rank."""
    return x if _alone(group) else _sum_forward(x, group)


def sum_backward(x: torch.Tensor, group) -> torch.Tensor:
    """x itself; the backward sums the gradient over ``group`` (each rank's
    shard of the weights gives a part of dx). Identity without a group or
    over one rank."""
    return x if _alone(group) else _sum_backward(x, group)


def gather_last(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' x concatenated on the last dim in rank order; the
    backward takes this rank's slice. Identity without a group or over one
    rank."""
    return x if _alone(group) else _gather_last(x, group)


# -- local shards ---------------------------------------------------------------

def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (differentiable), any other tensor itself."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


_HOST_MESHES = {}


def on_host(t: torch.Tensor, host_local: torch.Tensor) -> torch.Tensor:
    """``host_local``, a host tensor of t's local shape (a staged copy, or
    offloaded moments), laid out as t when t is a DTensor: a DTensor on a
    CPU twin of t's mesh (from_local would copy it to the card). Any other
    t: host_local itself."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return host_local
    mesh = t.device_mesh
    if mesh.device_type != "cpu":
        key = (mesh.mesh.tolist(), mesh.mesh_dim_names)
        key = repr(key)
        if key not in _HOST_MESHES:
            # layout only: no process group is made or used
            _HOST_MESHES[key] = DeviceMesh("cpu", mesh.mesh, mesh_dim_names=mesh.mesh_dim_names,
                                           _init_backend=False)
        mesh = _HOST_MESHES[key]
    return DTensor.from_local(host_local, mesh, t.placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def tp_group(module: nn.Module):
    """The tensor-parallel group a module's weights are sharded over (None:
    whole weights)."""
    return getattr(module, "_tp_group", None)


def embed(ids: torch.Tensor, emb: nn.Module) -> torch.Tensor:
    """F.embedding over a whole or a vocab-sharded table: under tp each
    rank looks up the ids in its rows, zero elsewhere, and the lookups are
    summed over tp."""
    w = local(emb.weight)
    group = tp_group(emb)
    if group is None:
        return F.embedding(ids, w)
    start = dist.get_rank(group) * w.shape[0]
    inside = (ids >= start) & (ids < start + w.shape[0])
    rows = F.embedding((ids - start).clamp(0, w.shape[0] - 1), w)
    return sum_forward(rows * inside[..., None].to(rows.dtype), group)


def rowwise_linear(x: torch.Tensor, mod: nn.Linear) -> torch.Tensor:
    """x w^T (+ b) in x's dtype; under tp, w holds this rank's input
    columns: the product of x's matching slice, summed over tp, then b."""
    w = local(mod.weight).to(x.dtype)
    group = tp_group(mod)
    if group is not None:
        start = dist.get_rank(group) * w.shape[1]
        x = x[..., start:start + w.shape[1]]
    y = sum_forward(F.linear(x, w), group)
    return y if mod.bias is None else y + local(mod.bias).to(x.dtype)


def vocab_start(head: nn.Module) -> int:
    """The first vocab id of this rank's shard of a head (0 when whole)."""
    group = tp_group(head)
    return 0 if group is None else dist.get_rank(group) * local(head.weight).shape[0]


def head_logits(h: torch.Tensor, head: nn.Module, dtype) -> torch.Tensor:
    """Full-vocab logits h w^T in ``dtype``: under tp each rank's shard of
    the vocab, gathered over tp."""
    group = tp_group(head)
    return gather_last(F.linear(sum_backward(h, group), local(head.weight).to(dtype)), group)


# -- the tensor-parallel plan ------------------------------------------------------

def _distribute(module: nn.Module, name: str, tp_mesh, placement) -> None:
    from torch.distributed.tensor import distribute_tensor

    p = getattr(module, name)
    module.register_parameter(name, nn.Parameter(
        distribute_tensor(p.data, tp_mesh, [placement]), requires_grad=p.requires_grad))


def apply_tp(model: nn.Module, tp_mesh, log=print) -> None:
    """Lay the model's parameters out over the tp mesh (the header's plan):
    the llama and touch_audio TrainSpecs' param_rules. Every tensor ends a DTensor on
    tp_mesh. Raises a ValueError naming training_tensor_parallel_degree when
    tp does not divide the attention heads."""
    from torch.distributed.tensor import Replicate, Shard

    from touchnet_tpu_torch.models.llama.modeling_llama import (
        LlamaDecoderLayer,
        LlamaMLP,
        LlamaModel,
    )

    tp = tp_mesh.size()
    for mod in model.modules():
        if isinstance(mod, LlamaDecoderLayer):
            cfg = mod.config
            if cfg.num_key_value_heads % tp or cfg.num_attention_heads % tp:
                raise ValueError(
                    f"training_tensor_parallel_degree={tp} does not divide "
                    f"num_key_value_heads={cfg.num_key_value_heads} (num_attention_heads="
                    f"{cfg.num_attention_heads}): each rank's attention kernels take whole "
                    "heads")
    group = tp_mesh.get_group()
    kept = []
    for mname, mod in model.named_modules():
        if isinstance(mod, LlamaDecoderLayer):
            mod = mod.self_attn
            for sub in (mod.q_proj, mod.k_proj, mod.v_proj):
                _distribute(sub, "weight", tp_mesh, Shard(0))
                if sub.bias is not None:
                    _distribute(sub, "bias", tp_mesh, Shard(0))
            _distribute(mod.o_proj, "weight", tp_mesh, Shard(1))
            mod._tp_group = group
        elif isinstance(mod, LlamaMLP):
            if mod.gate_proj.weight.shape[0] % tp:
                kept.append(f"{mname} (intermediate {mod.gate_proj.weight.shape[0]})")
                continue
            for sub in (mod.gate_proj, mod.up_proj):
                _distribute(sub, "weight", tp_mesh, Shard(0))
            _distribute(mod.down_proj, "weight", tp_mesh, Shard(1))
            mod._tp_group = group
        elif isinstance(mod, LlamaModel) or mname.endswith("lm_head"):
            target = mod.embed_tokens if isinstance(mod, LlamaModel) else mod
            tname = f"{mname}.embed_tokens" if isinstance(mod, LlamaModel) else mname
            if target.weight.shape[0] % tp:
                kept.append(f"{tname} (vocab {target.weight.shape[0]})")
                continue
            _distribute(target, "weight", tp_mesh, Shard(0))
            target._tp_group = group
        elif mname == "projector":  # touch_audio's
            if mod.weight.shape[1] % tp:
                kept.append(f"projector (input {mod.weight.shape[1]})")
                continue
            _distribute(mod, "weight", tp_mesh, Shard(1))
            mod._tp_group = group
    for mod in model.modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            if not hasattr(p, "placements"):
                _distribute(mod, name, tp_mesh, Replicate())
    if kept:
        log(f"tensor parallel {tp}: replicated where tp does not divide the dimension: "
            + ", ".join(kept))


# -- the compiled blocks ------------------------------------------------------------

def configure_compile() -> None:
    """torch.compile's settings for the compiled step, for this process:
    dynamo's caches and counters reset (what follows is one trainer's); a
    frame past the recompile limit raises, and so does a failed compile
    (no eager fallback); a Python float reaching a graph (a norm's eps) is
    a constant, never an input (under symbolic sizes dynamo would pass it
    as a host scalar tensor, for which inductor writes a CPU kernel); and
    inductor keeps the model's casts to the compute dtype (it would drop a
    bf16 round trip inside a fused kernel, so FSDP2's bf16 parameters and
    one process's casts of its f32 masters would give other bits)."""
    import torch._dynamo
    import torch._inductor.config
    from torch._dynamo.utils import counters

    torch._dynamo.reset()
    counters.clear()
    torch._dynamo.config.fail_on_recompile_limit_hit = True
    torch._dynamo.config.suppress_errors = False
    torch._dynamo.config.specialize_float = True
    torch._dynamo.config.automatic_dynamic_shapes = True
    torch._inductor.config.emulate_precision_casts = True


def mark_rows_dynamic(*tensors) -> None:
    """Make the batch and sequence dims (0 and 1) of each tensor of two or
    more dims symbolic in the graph it enters (dynamo's
    maybe_mark_dynamic; the widths stay static): the SFT loaders' batches
    change both every step, and a graph compiled so from the first call is
    the one every process, resumed or not, runs."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.dim() >= 2:
            torch._dynamo.maybe_mark_dynamic(t, 0)
            torch._dynamo.maybe_mark_dynamic(t, 1)


def apply_compile(model: nn.Module, *, fullgraph: bool = True,
                  dynamic_rows: bool = False) -> dict:
    """Give every trainable LlamaDecoderLayer and WhisperEncoderLayer of
    ``model`` a torch.compile of its class's checkpointed_block
    (modeling_llama.remat_block): the layer's checkpoint and its block in
    one graph, in which K1 and K2 run as custom ops (the reference's
    apply_compile, after the TP plan and AC, before FSDP). Each class is
    one compiled function, whose graphs all its layers share. Between
    them the two classes make every stack of the four families: llama's and touch_audio's layers, qwen2_audio's language
    model and audio tower, kimi_audio's layers, mimo layers and whisper
    tower. A layer without a trainable parameter (kimi_audio's frozen
    WhisperVQ tokenizer, run under no_grad with its dense block-causal
    attention) stays eager. ``fullgraph``: a graph break raises (False
    where a block holds a collective dynamo cannot take: the cp
    attention, the tp collectives); ``dynamic_rows``: each block's
    activations enter with symbolic batch and sequence dims
    (mark_rows_dynamic, modeling_llama.run_block), for batches whose shapes
    change every step. Returns {class: layers compiled}."""
    from touchnet_tpu_torch.models.llama.modeling_llama import LlamaDecoderLayer
    from touchnet_tpu_torch.models.whisper_encoder import WhisperEncoderLayer

    compiled, counts = {}, {}
    for mod in model.modules():
        if isinstance(mod, (LlamaDecoderLayer, WhisperEncoderLayer)) and any(
                p.requires_grad for p in mod.parameters()):
            cls = type(mod)
            if cls not in compiled:
                compiled[cls] = torch.compile(cls.checkpointed_block, fullgraph=fullgraph)
            mod.compiled_block = compiled[cls]
            mod.dynamic_rows = dynamic_rows
            counts[cls] = counts.get(cls, 0) + 1
    return counts


# -- FSDP2 --------------------------------------------------------------------------

RESHARD = {"default": True, "always": True, "never": False}


def apply_fsdp(root: nn.Module, model: nn.Module, dp_mesh, param_dtype, reduce_dtype,
               reshard_after_forward: str = "default") -> None:
    """fully_shard every layer of the model's ModuleLists, then ``root``
    (a module whose forward runs the whole step's forward and loss, so the
    remaining parameters are gathered for it), over dp_mesh, with the sum
    as the data-parallel reduction. The layers' parameters are gathered in
    param_dtype; the root's (the embeddings, the final norm, the head) in
    reduce_dtype, the dtype the one-process trainer differentiates (its f32
    masters, or their bf16 copies under bf16 reduction), and the model
    casts them at use: a tied embedding's lookup and head gradients, or a
    repeated id's rows, then add up in that dtype as in one process (in
    bf16 parameters they would add up in bf16)."""
    from torch.distributed.fsdp import FSDPModule, MixedPrecisionPolicy, fully_shard

    if reshard_after_forward not in RESHARD:
        raise ValueError(f"training_fsdp_reshard_after_forward {reshard_after_forward!r}: "
                         f"one of {sorted(RESHARD)}")
    # the model casts its own inputs: FSDP's cast of floating forward inputs
    # would round each layer's f32 rope frequencies to bf16
    mp = MixedPrecisionPolicy(param_dtype=param_dtype, reduce_dtype=reduce_dtype,
                              cast_forward_inputs=False)
    root_mp = MixedPrecisionPolicy(param_dtype=reduce_dtype, reduce_dtype=reduce_dtype,
                                   cast_forward_inputs=False)
    raf = RESHARD[reshard_after_forward]
    for mod in list(model.modules()):
        if isinstance(mod, nn.ModuleList):
            for layer in mod:
                if any(p.numel() for p in layer.parameters()):
                    fully_shard(layer, mesh=dp_mesh, mp_policy=mp, reshard_after_forward=raf)
    fully_shard(root, mesh=dp_mesh, mp_policy=root_mp, reshard_after_forward=raf)
    for mod in root.modules():
        if isinstance(mod, FSDPModule):
            # a plain SUM on the wire (gloo takes no PREMUL_SUM), divided by 1
            mod.set_gradient_divide_factor(1.0)
            mod.set_force_sum_reduction_for_comms(True)


def reshard(root: nn.Module) -> None:
    """Every FSDP unit back to its shards (before reading a state dict)."""
    from torch.distributed.fsdp import FSDPModule

    for mod in root.modules():
        if isinstance(mod, FSDPModule):
            mod.reshard()


def dp_mesh_of(mesh, dp_replicate: int):
    """The mesh FSDP shards over: JAX's FSDP_AXES, dp_shard and cp, as one
    dimension ("dp_shard_cp": each cp rank's gradient is the sum over its
    own tokens, so the reduction stays a sum over both); under HSDP or DDP
    (dp_replicate, that dimension)."""
    flat = mesh["dp_shard", "cp"]._flatten("dp_shard_cp")
    return mesh["dp_replicate", "dp_shard_cp"] if dp_replicate > 1 else flat
