"""Per-rank dry run of every (architecture x input shape x variant x mesh)
cell (ports the counting part of ``repro/launch/dryrun.py``).

    python -m repro_torch.launch.dryrun [--arch all|a,b] [--shape all|s,t]
        [--mesh single|multi|both] [--variant all|v] [--out DIR]
        [--tag TAG]

The reference lowers and compiles each cell's step on 512 placeholder
devices and reads XLA's memory, cost and collective analysis.  The port
counts each cell per rank instead, allocating nothing: the parameters
are built on the ``meta`` device, the meshes are the production layouts'
axis sizes (``launch.mesh.mesh_config``: (16, 16) data x model, or (2,
16, 16) pod x data x model) with no process group, and per cell it
records

* bytes per rank: the parameters' blocks under ``param_specs`` (``serve``
  mode for the decode variants, ``train`` otherwise, as the reference's
  ``build_cell``), AdamW's f32 ``m`` / ``v`` blocks for ``train``, and for
  the decode variants the blocks of the state the port's serve steps take
  (``serving/serve_step.py``: the FullKV caches, or the ThinKV pool, its
  metadata and TBQ buffer; the SSM and hybrid states; the
  encoder-decoder's cross KV) under ``decode_batch_specs``;
* FLOPs: ``roofline.analysis.model_flops_for`` plus
  ``attention_flops_for`` over the chips;
* for ``train``, the collective bytes this rank sends in one step by
  (kind, axis, what): the sharded train step's own analytic count of its
  gathers and sums (:func:`train_traffic`), equal to what
  ``distributed.sharding.TRAFFIC`` measures in the step;
* the three roofline terms of ``roofline.analysis.RooflineTerms``, the
  memory term over the bytes a rank holds.

The port's weights are f32 (its steps compute in f32), so are the
gradients and moments.  Each cell is a JSON file ``<arch>__<shape>__
<variant>__<mesh>.json`` under ``--out`` (by default ``build/dryrun/``),
``__<TAG>`` appended to the name with ``--tag``.  Every cell is counted
again on every run.  Not ported: the lowering and compilation, XLA's
``memory_analysis`` (activations and temporaries) and the HLO collective
parse, which have no PyTorch meaning; the decode cells'
``REPRO_DECODE_FSDP`` baseline switch; ``--force`` (the reference skips a
cell whose file exists because its cell compiles; a count compiles
nothing).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import SHAPES, ArchFamily, InputShape, ModelConfig, \
    ThinKVConfig
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import param_paths, param_shapes
from repro_torch.core.ct_cache import SCALE_DTYPE, make_dims
from repro_torch.core.quantization import GROUP
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import mesh_config
from repro_torch.layers.moe import group_size
from repro_torch.layers.ssm import mamba1_dims, mamba2_dims
from repro_torch.models import lm
from repro_torch.models.losses import chunk_size
from repro_torch.roofline import analysis as RA

THINKV_BUDGET = 1024
OUT_DIR = os.path.join("build", "dryrun")
F32 = 4
Traffic = Dict[Tuple[str, str, str], int]


def variants_for(arch: str, shape_name: str):
    """The reference's variants of a cell: ``train``, ``prefill``, or the
    decode steps (FullKV and ThinKV; FullKV alone for the SSM family, and
    at 500k ThinKV alone for the attention families)."""
    cfg = get_config(arch)
    kind = SHAPES[shape_name].kind
    if kind == "train":
        return ["train"]
    if kind == "prefill":
        return ["prefill"]
    if shape_name == "decode_32k":
        if cfg.family == ArchFamily.SSM:
            return ["decode_fullkv"]
        return ["decode_fullkv", "decode_thinkv"]
    if cfg.family == ArchFamily.SSM:
        return ["decode_fullkv"]
    if cfg.family == ArchFamily.HYBRID:
        return ["decode_fullkv", "decode_thinkv"]
    return ["decode_thinkv"]


def meta_params(cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The port model's parameters on the ``meta`` device (no storage)."""
    return {n: torch.empty(s, device="meta")
            for n, s in param_shapes(cfg).items()}


def _nbytes(shape, elem: int) -> int:
    return math.prod(shape) * elem


def decode_state(cfg: ModelConfig, shape: InputShape, budget: int
                 ) -> Dict[str, torch.Tensor]:
    """The batch one decode step of the port's serve steps takes, on the
    ``meta`` device: one token per request and its state, a FullKV cache
    of ``shape.seq_len`` rows (``budget`` 0) or the ThinKV pool bound by
    ``budget``."""
    b, s = shape.global_batch, shape.seq_len
    hd, hkv = cfg.head_dim, cfg.num_kv_heads
    u8, bf16, i32, f32 = torch.uint8, torch.bfloat16, torch.int32, \
        torch.float32
    out = {"tokens": ((b,), i32), "positions": ((b,), i32)}
    if cfg.family == ArchFamily.SSM:
        di, _, n, cw = mamba1_dims(cfg)
        out.update(conv_state=((b, cfg.num_layers, cw, di), f32),
                   ssm_state=((b, cfg.num_layers, di, n), f32))
        return _meta(out)
    n_attn = cfg.num_attention_layers()
    if cfg.family == ArchFamily.HYBRID:
        di, nh, hp, g, n, cw = mamba2_dims(cfg)
        out.update(conv_state=((b, cfg.num_layers, cw, di + 2 * g * n), f32),
                   ssm_state=((b, cfg.num_layers, nh, hp, n), f32))
    if budget > 0:
        dims = make_dims(ThinKVConfig(token_budget=budget), n_attn, hkv, hd)
        plane = (b, n_attn, dims.NB, dims.BS, hkv)
        out.update(k_codes=(plane + (hd,), u8), v_codes=(plane + (hd,), u8),
                   k_scales=(plane + (dims.scale_groups,), SCALE_DTYPE),
                   v_scales=(plane + (dims.scale_groups,), SCALE_DTYPE),
                   slot_state=((b, n_attn, dims.NS), u8),
                   slot_bits=((b, n_attn, dims.NS), u8),
                   buf_k=((b, n_attn, dims.G, hkv, hd), bf16),
                   buf_v=((b, n_attn, dims.G, hkv, hd), bf16),
                   buf_len=((b,), i32))
    else:
        out.update(k_cache=((b, n_attn, s, hkv, hd), bf16),
                   v_cache=((b, n_attn, s, hkv, hd), bf16),
                   cache_len=((b,), i32))
    if cfg.family == ArchFamily.ENCDEC:
        cross = (b, cfg.num_layers, cfg.encoder_seq, hkv)
        if budget > 0:
            out.update(cross_k_codes=(cross + (hd,), u8),
                       cross_v_codes=(cross + (hd,), u8),
                       cross_k_scales=(cross + (hd // GROUP,), bf16),
                       cross_v_scales=(cross + (hd // GROUP,), bf16))
        else:
            out.update(cross_k=(cross + (hd,), bf16),
                       cross_v=(cross + (hd,), bf16))
    return _meta(out)


def _meta(spec: dict) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(s, dtype=dt, device="meta")
            for k, (s, dt) in spec.items()}


def _add(t: Traffic, kind: str, axis: str, what: str, n: int) -> None:
    if axis and n:
        t[(kind, axis, what)] = t.get((kind, axis, what), 0) + n


def _unshard_count(t: Traffic, shape, spec, mesh, what: str) -> None:
    """``sharding.unshard``'s all-gathers: one per split dim, in order,
    each sending what is gathered so far."""
    block = list(SH.block_shape(shape, spec, mesh))
    for dim, axes in enumerate(spec):
        live = SH.live_axes(mesh, axes)
        if live:
            _add(t, "all_gather", SH.axis_label(mesh, live), what,
                 _nbytes(block, F32))
            block[dim] *= SH.axes_size(mesh, live)


def train_traffic(cfg: ModelConfig, mesh, batch: int, seq: int, *,
                  microbatches: int = 1, remat: bool = True,
                  loss_mask: bool = False, grad_transform: bool = False
                  ) -> Traffic:
    """The bytes this rank sends in one sharded train step of ``cfg`` on
    ``mesh`` (``axis_names`` and ``shape``; no group needed) over a global
    batch of ``batch`` x ``seq`` tokens (``training/train_step.py``, f32
    weights), by (kind, axis label, what) as ``sharding.TRAFFIC`` counts
    them.  Every count follows the step's code: ``remat`` reruns each
    layer's forward collectives in backward up to the last one whose
    result a later op saves (``torch.utils.checkpoint`` stops its
    recompute there), and the cross entropy's chunks are always
    checkpointed."""
    return _StepCount(cfg, mesh, batch, seq, microbatches, remat, loss_mask,
                      grad_transform).traffic


class _StepCount:
    """One sharded train step's collective bytes (:func:`train_traffic`)."""

    def __init__(self, cfg, mesh, batch, seq, microbatches, remat,
                 loss_mask, grad_transform):
        self.cfg, self.mesh, self.seq = cfg, mesh, seq
        self.traffic: Traffic = {}
        self.specs = SH.param_specs(cfg, mesh, mode="train")
        self.shapes = param_shapes(cfg)
        self.paths = param_paths(cfg)
        self.dp = SH.axis_label(mesh, SH.dp_axes(mesh))
        self.mdl = SH.axis_label(mesh, SH.MODEL_AXIS)
        self.ndp = SH.axes_size(mesh, SH.live_axes(mesh, SH.dp_axes(mesh)))
        self.tp = SH.model_size(mesh)
        bmb = batch // microbatches
        # does each microbatch split over dp (``train_batch_specs``)?
        self.split = self.ndp > 1 and bmb % self.ndp == 0
        self.bl = bmb // self.ndp if self.split else bmb
        self.patches = cfg.family == ArchFamily.VLM and \
            cfg.num_image_tokens > 0
        self.rows = seq + (cfg.num_image_tokens if self.patches else 0)
        self.act = self.bl * self.rows * cfg.d_model * F32
        self.reps = 2 if remat else 1
        family = {ArchFamily.SSM: self.ssm_microbatch,
                  ArchFamily.HYBRID: self.hybrid_microbatch,
                  ArchFamily.ENCDEC: self.encdec_microbatch}.get(
                      cfg.family, self.lm_microbatch)
        for _ in range(microbatches):
            family()
            self.mask(loss_mask)
        self.add("all_reduce", self.dp, "grad", sum(
            _nbytes(self.block(n), F32) for n in self.shapes
            if SH.dp_dim(self.specs[n], mesh) is None))
        if grad_transform:
            for n, shape in self.shapes.items():
                _unshard_count(self.traffic, shape, self.specs[n], mesh,
                               "grad")
        else:                                   # the gradient norm
            self.add("all_reduce", self.dp, "other", F32)
            self.add("all_reduce", self.mdl, "other", F32)
        # the means of the loss and the metrics (nll, moe_aux)
        self.add("all_reduce", self.dp, "other",
                 F32 * (1 + (2 if microbatches == 1 else 0)))

    def add(self, kind: str, axis: str, what: str, n: int) -> None:
        _add(self.traffic, kind, axis, what, n)    # no axis: no collective

    def sums(self, n: int) -> None:
        """All-reduces over ``model`` of activations (or, ``to_model`` of
        a replicated weight read in part, of its gradient): n bytes."""
        self.add("all_reduce", self.mdl, "act", n)

    def moves(self, n: int) -> None:
        """All-gathers over ``model`` of activations: n bytes."""
        self.add("all_gather", self.mdl, "act", n)

    def mask(self, loss_mask: bool) -> None:
        """The masked positions' count over dp."""
        if self.split and loss_mask:
            self.add("all_reduce", self.dp, "other", F32)

    def block(self, name: str, layer: bool = False):
        shape = SH.block_shape(self.shapes[name], self.specs[name],
                               self.mesh)
        return shape[1:] if layer else shape

    def under(self, root: str):
        """The parameter names under ``root`` of the reference's tree."""
        return [n for n, p in self.paths.items() if p[0] == root]

    def gathered(self, name: str, times: int, layer: bool = False) -> None:
        """``gather_dp`` of a block: ``times`` forward all-gathers, one
        reduce-scatter of the gathered gradient."""
        if SH.dp_dim(self.specs[name], self.mesh) is None:
            return
        b = _nbytes(self.block(name, layer), F32)
        self.add("all_gather", self.dp, "param", b * times)
        self.add("reduce_scatter", self.dp, "grad", b * self.ndp)

    def layer(self, root: str, times: int) -> None:
        for n in self.under(root):
            self.gathered(n, times, layer=True)

    def embed(self) -> None:
        """The embedding, gathered over dp once (the tied head reuses it)
        and vocab-parallel."""
        self.gathered("embedding", 1)
        if self.block("embedding")[0] < self.cfg.vocab_size:
            self.sums(self.bl * self.seq * self.cfg.d_model * F32)

    def head(self) -> None:
        """The head and the vocab-parallel chunked cross entropy."""
        cfg, v = self.cfg, self.cfg.vocab_size
        if not cfg.tie_embeddings:
            self.gathered("lm_head", 1)
        cols = self.block("embedding")[0] if cfg.tie_embeddings \
            else self.block("lm_head")[-1]
        if cols < v:
            self.sums(self.bl * self.seq * cfg.d_model * F32)
            chunk = chunk_size(self.bl, self.seq, v)
            # per chunk: the row max, the sum of exponentials, the
            # target's logit, in the forward and in the recompute
            self.sums(3 * 2 * self.bl * chunk * F32 * (self.seq // chunk))

    def lm_microbatch(self) -> None:
        """One microbatch of ``lm.loss_fn`` from a rank's ``lm.Weights``."""
        cfg = self.cfg
        self.embed()
        if self.patches:
            self.gathered("frontend_proj", 1)
        for _ in range(cfg.num_layers):
            for n in lm.layer_params(cfg):
                self.gathered(n, self.reps, layer=True)
            self.attention()
            if cfg.moe is not None:
                self.moe()
            else:
                self.mlp()
        self.head()

    def ssm_microbatch(self) -> None:
        """One microbatch of ``ssm_lm.loss_fn``."""
        self.embed()
        for _ in range(self.cfg.num_layers):
            self.layer("layers", self.reps)
            self.mamba1()
        self.head()

    def hybrid_microbatch(self) -> None:
        """One microbatch of ``hybrid.loss_fn``: the shared block (not
        remat'd) gathered over dp at each invocation."""
        cfg = self.cfg
        e = cfg.hybrid_attn_every
        ng, tail = cfg.num_layers // max(e, 1), cfg.num_layers % max(e, 1)
        self.embed()
        for gi in range(ng + 1):
            for _ in range(e if gi < ng else tail):
                self.layer("layers", self.reps)
                self.mamba2()
            if gi < ng:
                for n in self.under("shared"):
                    self.gathered(n, 1)
                self.attention(stacked=False, reps=1)
                self.mlp(stacked=False)
        self.head()

    def encdec_microbatch(self) -> None:
        """One microbatch of ``encdec.loss_fn``: the encoder (not remat'd)
        over ``encoder_seq`` frames, the decoder's remat'd layers."""
        cfg, t = self.cfg, self.cfg.encoder_seq
        self.embed()
        self.gathered("enc_pos", 1)
        self.gathered("dec_pos", 1)
        for _ in range(cfg.encoder_layers):
            self.layer("encoder", 1)
            self.attention("encoder_attn_", rows=t, reps=1)
            self.mlp("encoder_", rows=t)
        for _ in range(cfg.num_layers):
            self.layer("decoder", self.reps)
            self.attention("decoder_self_attn_")
            self.attention("decoder_cross_attn_", kv_rows=t)
            self.mlp("decoder_")
        self.head()

    def mlp(self, pre: str = "", stacked: bool = True,
            rows: int = 0) -> None:
        """``mlp_split``: to_model's backward, from_model's forward: the
        block's last collective, which remat's recompute stops short of
        (no later op of the block saves a tensor for backward)."""
        if self.block(pre + "w_up", stacked)[-1] < self.cfg.d_ff:
            self.sums(2 * self.bl * (rows or self.rows) * self.cfg.d_model
                      * F32)

    def attention(self, pre: str = "", stacked: bool = True, rows: int = 0,
                  reps: int = 0, kv_rows: int = 0) -> None:
        """``attn_forward_split`` of the weights ``pre + "wq"``, ...; with
        ``kv_rows``, cross attention over that many encoder rows."""
        cfg, reps = self.cfg, reps or self.reps
        rows = rows or self.rows
        krows = kv_rows or rows
        act = self.bl * rows * cfg.d_model * F32
        blk = lambda w: self.block(pre + w, stacked)  # noqa: E731
        cols = {"wq": cfg.q_dim, "wk": cfg.kv_dim, "wv": cfg.kv_dim}
        split = {w: blk(w)[-1] < n for w, n in cols.items()}
        split_o = blk("wo")[0] < cfg.q_dim
        if not kv_rows and any(split.values()):
            self.sums(act)                                    # to_model
        elif kv_rows:
            if split["wq"]:
                self.sums(act)
            if split["wk"] or split["wv"]:
                self.sums(self.bl * krows * cfg.d_model * F32)
        if cfg.num_kv_heads % self.tp == 0 and all(split.values()) and \
                split_o:
            self.sums(act * reps)
            if cfg.qkv_bias:                     # split_model's backward
                self.moves(F32 * (blk("wq")[-1] + (
                    0 if kv_rows else 2 * blk("wk")[-1])))
            return
        for w in cols:
            if split[w]:
                self.moves(self.bl * (rows if w == "wq" else krows)
                           * blk(w)[-1] * F32 * reps)
        if split_o:
            self.moves(self.bl * rows * blk("wo")[0] * F32)
            self.sums(act * reps)

    def mamba1(self) -> None:
        """``ssm.mamba1_forward_split`` of one layer."""
        di, dtr, n, _ = mamba1_dims(self.cfg)
        tok, reps = self.bl * self.seq * F32, self.reps
        bw = self.block("out_proj", True)[0]
        cols = self.block("in_proj", True)[-1]
        if cols < 2 * di:
            self.sums(self.act)                 # to_model of the input
        if bw == di:                            # d_inner whole
            if cols < 2 * di:
                self.moves(tok * cols * reps)
            return
        self.regroup(tok, cols, 2 * di)
        # conv_b, dt_bias, D: split_model's backward
        self.moves(3 * bw * F32)
        # x_proj's sum (forward, recomputed) and to_model's backward
        self.sums(tok * (dtr + 2 * n) * (reps + 1))
        self.sums(self.act)                     # out_proj's sum, once

    def mamba2(self) -> None:
        """``ssm.mamba2_forward_split`` of one layer."""
        di, nh, _, g, n, cw = mamba2_dims(self.cfg)
        cdim, width = di + 2 * g * n, 2 * di + 2 * g * n + nh
        tok, reps = self.bl * self.seq * F32, self.reps
        bw = self.block("out_proj", True)[0]
        cb = self.block("conv_w", True)[0]
        cols = self.block("in_proj", True)[-1]
        if cols < width:
            self.sums(self.act)                 # to_model of the input
        if bw == di:                            # d_inner whole
            if cols < width:
                self.moves(tok * cols * reps)
            if cb < cdim:
                self.sums(tok * cdim)           # to_model of the conv input
                self.moves(tok * cb * reps + cb * F32)
            return
        self.regroup(tok, cols, width)
        if cb < cdim:                           # conv_b, then the regroup
            self.moves(cb * F32)
            self.regroup(tok, cb, cdim)
        else:                                   # to_model of conv_w, conv_b
            self.sums((cdim * cw + cdim) * F32)
        self.sums(3 * nh * F32)                 # to_model of the heads'
        self.moves(bw * F32)                    # the norm's split_model
        # the mean of squares' sum (recomputed) and to_model's backward
        self.sums(tok * (reps + 1))
        self.sums(self.act)                     # out_proj's sum, once

    def regroup(self, tok: int, cols: int, width: int) -> None:
        """``sharding.regroup_model`` of an activation of ``tok`` bytes per
        column: a block of ``cols`` columns gathered (recomputed) and its
        ``width`` columns' gradient reduce-scattered, or all of it whole
        (``to_model``'s backward)."""
        if cols < width:
            self.moves(tok * cols * self.reps)
            self.add("reduce_scatter", self.mdl, "act", tok * width)
        else:
            self.sums(tok * width)

    def moe(self) -> None:
        cfg, act, reps = self.cfg, self.act, self.reps
        e, k = cfg.moe.num_experts, cfg.moe.num_experts_per_token
        w_up = self.block("w_up", True)
        if w_up[0] < e or w_up[-1] < cfg.d_ff:
            # to_model's backward of the tokens and the gates, from_model
            self.add("all_reduce", self.mdl, "act",
                     act + self.bl * self.rows * k * F32 + act * reps)
        if not self.split:
            return
        n_loc = self.bl * self.rows
        gsz = group_size(n_loc * self.ndp, cfg.moe.dispatch_group)
        if n_loc % gsz and gsz % n_loc == 0:     # queue places over dp
            self.add("all_gather", self.dp, "other", e * 4 * reps)
        self.add("all_reduce", self.dp, "other", e * F32 * reps)  # top-1
        self.add("all_reduce", self.dp, "other",
                 e * F32 * (reps + 1))           # the router's means


def _bytes_per_rank(tensors: Dict[str, torch.Tensor], specs: dict,
                    mesh) -> int:
    return sum(_nbytes(SH.block_shape(x.shape, specs[k], mesh),
                       x.element_size()) for k, x in tensors.items())


def count_cell(arch: str, shape_name: str, variant: str,
               mesh_kind: str) -> dict:
    """One cell's per-rank count (see the module docstring)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = mesh_config(multi_pod=mesh_kind == "multi")
    chips = mesh.num_devices
    params = meta_params(cfg)
    mode = "serve" if variant.startswith("decode") else "train"
    pspecs = SH.param_specs(cfg, mesh, mode=mode)
    pbytes = _bytes_per_rank(params, pspecs, mesh)
    rec = {"cell": f"{arch}__{shape_name}__{variant}__{mesh_kind}",
           "arch": arch, "shape": shape_name, "variant": variant,
           "mesh": mesh_kind, "axes": dict(zip(mesh.axis_names, mesh.shape)),
           "chips": chips, "param_mode": mode,
           "param_bytes_per_rank": pbytes,
           "all_meta": all(p.device.type == "meta" for p in params.values())}
    state = 0
    traffic: Traffic = {}
    if variant == "train":
        state = 2 * pbytes                 # f32 m and v beside f32 weights
        traffic = train_traffic(cfg, mesh, shape.global_batch, shape.seq_len)
        rec["opt_state_bytes_per_rank"] = state
        rec["collectives"] = {"/".join(k): n for k, n in
                              sorted(traffic.items())}
    elif variant.startswith("decode"):
        budget = 0 if variant == "decode_fullkv" or \
            cfg.family == ArchFamily.SSM else THINKV_BUDGET
        batch = decode_state(cfg, shape, budget)
        state = _bytes_per_rank(batch, SH.decode_batch_specs(batch, mesh),
                                mesh)
        rec["state_bytes_per_rank"] = state
        rec["all_meta"] &= all(x.device.type == "meta"
                               for x in batch.values())
    model = RA.model_flops_for(cfg, shape, variant)
    attn = RA.attention_flops_for(cfg, shape, variant)
    terms = RA.RooflineTerms(
        arch=arch, shape=shape_name, variant=variant, mesh=mesh_kind,
        chips=chips, flops_per_device=(model + attn) / chips,
        bytes_per_device=float(pbytes + state),
        collective_bytes_per_device=float(sum(traffic.values())),
        model_flops=model)
    rec.update(bytes_per_rank=pbytes + state, attention_flops=attn,
               roofline=terms.to_dict(), status="ok")
    return rec


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="all")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--tag", default="",
                    help="suffix for the cells' file names (reruns)")
    args = ap.parse_args(argv)
    archs = ARCHS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    os.makedirs(args.out, exist_ok=True)
    t_all, n = time.perf_counter(), 0
    for arch in archs:
        for shape_name in shapes:
            for variant in variants_for(arch, shape_name):
                if args.variant not in ("all", variant):
                    continue
                for mesh_kind in meshes:
                    t0 = time.perf_counter()
                    rec = count_cell(arch, shape_name, variant, mesh_kind)
                    if args.tag:
                        rec["cell"] += f"__{args.tag}"
                    rec["seconds"] = time.perf_counter() - t0
                    with open(os.path.join(args.out, rec["cell"] + ".json"),
                              "w") as f:
                        json.dump(rec, f, indent=2)
                    n += 1
                    gb = rec["bytes_per_rank"] / 1e9
                    sent = "" if "collectives" not in rec else \
                        f", {sum(rec['collectives'].values()) / 1e9:.2f} " \
                        f"GB/rank sent per step"
                    print(f"[OK ] {rec['cell']}  {gb:.2f} GB/rank{sent}, "
                          f"bound {rec['roofline']['bottleneck']}  "
                          f"({rec['seconds']:.2f}s)", flush=True)
    print(f"\ndry-run complete: {n} cells in "
          f"{time.perf_counter() - t_all:.1f}s -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
