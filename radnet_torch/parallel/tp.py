"""Tensor-parallel RoI heads: the Megatron split of ``parallel/mesh.py``'s
rules, float and int8, forward and backward.

:func:`shard_head_` replaces a head's split parameters by this rank's
shards (``nn.Parameter`` s under the same names, so an optimizer over the
model holds the shards); :func:`tp_head` wraps such a head in a module that
runs where the full head would (``FasterRCNN.roi_heads(..., head=)``), with
the same outputs on every rank of the model axis.  Training shards the
model's own head (``mesh.shard_train_state``); serving shards a copy
(:func:`build_tp_head`).  The wrapper reads the parameters when it runs, so
it follows every update.  Its input, the RoI pool, is
the rank's own: each process computes the replicated trunk itself, and the
split layers combine pieces of one and the same input only while every
rank computes the same bits.  ``parallel/launch.py`` gives every rank the
caller's numeric settings for that; ranks with other settings would mix two
inputs in every split product without a sign (``chip_smoke.py``'s
``mesh_serve`` gates the ranks' pooled inputs equal).

ResNet50 stage 5, per block:

* ``conv2a`` row-parallel: a partial product over this rank's input
  channels, all-reduced over the model axis, the bias once, then ``bn2a``
  and ReLU.  s5a reads the replicated RoI pool and takes its channel slice.
* ``conv2b`` replicated.
* ``conv2c`` (and s5a's ``conv_sc``) column-parallel: this rank's output
  channels, ``bn2c`` / ``bn_sc`` cut to match after ``affine`` (never
  recomputed per shard), the residual sum and ReLU on the shard, which
  feeds the next block's ``conv2a``.
* The 7x7 average pool on the shard; the output layers row-parallel: one
  all-reduce of both layers' partials, then the biases once, then softmax.

VGG16: ``fc1`` column-parallel (bias cut) and ReLU; ``fc2`` row-parallel,
all-reduced, the bias once, ReLU; the output layers replicated.  Dropout
takes ``fc1``'s mask cut to this rank's columns and ``fc2``'s whole.

Backward: a replicated tensor that enters split layers (the RoI pool into
s5a's ``conv2a`` slice and ``conv_sc``, each block's ``conv2b`` output into
``conv2c``, VGG16's pool into ``fc1``) passes Megatron's f, whose gradient
is all-reduced over the model axis; every all-reduce of partial sums is
Megatron's g, whose gradient passes as it is
(``collectives.copy_to_model`` / ``reduce_from_model``).  So the gradient
that reaches ``conv2b``, the batch norms' inputs and the trunk is the whole
one on every rank, and a replicated parameter's gradient comes out the same
on every rank of the model axis, up to the order of a nondeterministic
backward's sums (the train step takes model index 0's,
``collectives.all_reduce_grads``).  The frozen batch norms take no
gradient.

Float: a row-parallel layer's partials are float32 products of the
compute-type values (exact products, float32 sums), all-reduced in float32
and rounded to the compute type once, where the single device rounds its
one product once.  Only the order of the float32 sums differs, so the head
is held to the single device by tolerance.  All-reducing bf16 partials
instead would round each rank's partial to bf16 before the sum: up to M
roundings of 2^-9 relative, where the single device has one.

Int8 (forward only; int8 never trains): bit-equal to the single-device
int8 head.  A quantization scale over
a row that the model axis splits (a sharded activation; a row-parallel
layer's weight rows, quantized when first used and again after the
weights change) is the
all-reduced MAX of the pieces' amaxes
(``quant.quantize_rows_amax``, then ``quantize_rows_given``), as JAX's GSPMD
all-reduces its max; a max is exact in any order.  A row-parallel product
writes its int32 sums, all-reduced by SUM (exact in any order), and
``quant.int8_epilogue`` then runs the fused epilogue's arithmetic on them.
The pooled vector after stage 5 (2048 floats a RoI) is gathered over the
model axis and the output layers run whole on every rank: a float32 product
split over ranks would sum in another order, so the int8 head keeps them
replicated where the float head splits them.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

from radnet_torch.models import resnet, vgg
from radnet_torch.ops import quant
from radnet_torch.parallel.collectives import (all_gather, all_reduce, copy_to_model,
                                               reduce_from_model)
from radnet_torch.parallel.mesh import MODEL_AXIS, Mesh, make_param_shardings, shard_of


def head_shard_dims(head, mesh: Mesh, warn_label: str | None = None) -> dict[str, int]:
    """``{parameter name under the head: sharded dimension}`` of ``head``
    (full) over ``mesh``'s model axis; empty where the axis has one rank or
    nothing matches a rule (a warning is printed then, as the JAX package
    prints it).  Raises on a head whose shardable parameters shard only in
    part."""
    if mesh.model == 1:
        return {}
    state = {f"head.{k}": v for k, v in head.named_parameters()}
    dims = make_param_shardings(state, mesh.model, warn_label=warn_label)
    sharded = {k for k, d in dims.items() if d is not None}
    ruled = {k for k, d in make_param_shardings(state, 1).items() if d is not None}
    if sharded and sharded != ruled:
        raise ValueError(f"the head shards only in part over a model axis of {mesh.model}: "
                         f"{sorted(ruled - sharded)[:4]} do not divide it")
    return {k[len("head."):]: dims[k] for k in sorted(sharded)}


def shard_head_(head, mesh: Mesh, warn_label: str | None = None) -> dict[str, int]:
    """Replace ``head``'s split parameters by this rank's shards, in place
    (new ``nn.Parameter`` s, ``requires_grad`` kept); returns
    :func:`head_shard_dims`."""
    dims = head_shard_dims(head, mesh, warn_label)
    for name, dim in dims.items():
        owner_name, attr = name.rsplit(".", 1)
        owner = head.get_submodule(owner_name)
        p = getattr(owner, attr)
        setattr(owner, attr, nn.Parameter(shard_of(p.detach(), dim, mesh),
                                          requires_grad=p.requires_grad))
    return dims


def tp_head(head, mesh: Mesh):
    """The tensor-parallel module over ``head``, whose split parameters are
    this rank's shards (:func:`shard_head_`)."""
    if isinstance(head, resnet.ResNet50RoIHead):
        return TPResNet50Head(head, mesh)
    if isinstance(head, vgg.VGG16RoIHead):
        return TPVGG16Head(head, mesh)
    raise TypeError(f"no tensor-parallel form of {type(head).__name__}")


def build_tp_head(head, mesh: Mesh):
    """Serving's tensor-parallel counterpart of ``head`` on ``mesh``'s model
    axis, over a sharded copy (``head`` stays whole), or None where the axis
    has one rank or no parameter shards."""
    if not head_shard_dims(head, mesh, warn_label="serving"):
        return None
    shards = copy.deepcopy(head)
    shard_head_(shards, mesh)
    return tp_head(shards, mesh)


def _row_parallel_int8(xq: quant.Quantized, wq: quant.Quantized, bias: torch.Tensor,
                       rows_per_sample: int, mesh: Mesh, **epi) -> torch.Tensor:
    """An int8 product whose K is split over the model axis: ``xq`` (M, K_r)
    this rank's columns and ``wq`` (N, K_r) this rank's part of the weight
    rows, each with the whole row's scale.  The int32 sums are all-reduced
    before the epilogue."""
    acc = all_reduce(quant.int8_gemm_sums(xq, wq, rows_per_sample), mesh, MODEL_AXIS)
    return quant.int8_epilogue(acc, xq.scale, wq.scale, bias, rows_per_sample, **epi)


def _quantize_sharded(x: torch.Tensor, mesh: Mesh) -> quant.Quantized:
    """Rows whose values the model axis splits, quantized with the whole
    row's scale."""
    amax = all_reduce(quant.quantize_rows_amax(x), mesh, MODEL_AXIS, op="max")
    return quant.quantize_rows_given(x, amax)


class _WeightCache:
    """What a forward derives from a weight once (the int8 rows of a
    row-parallel weight, with the whole rows' scales; a split weight
    gathered whole), made again only after the weight changes (its version
    counter), so a forward pays no collective for it otherwise."""

    def __init__(self):
        self._cache: dict[tuple[int, str], tuple[int, object]] = {}

    def __call__(self, w: torch.Tensor, kind: str, make):
        key = (id(w), kind)
        hit = self._cache.get(key)
        if hit is None or hit[0] != w._version:
            hit = (w._version, make(w.detach()))
            self._cache[key] = hit
        return hit[1]


def _bn_shard(bn, dt, like: torch.Tensor, mesh: Mesh):
    """A column-parallel layer's batch norm: the full ``(k, b)``, cut to
    this rank's channels (``like``: the layer's output-channel shard)."""
    k, b = bn.affine(dt)
    n = like.shape[0]
    cut = slice(mesh.model_index * n, (mesh.model_index + 1) * n)
    return k[cut], b[cut]


class TPResNet50Head(nn.Module):
    """The ResNet50 stage-5 head over the model axis (see the module doc)."""

    def __init__(self, head: resnet.ResNet50RoIHead, mesh: Mesh):
        super().__init__()
        self.head = head
        self.mesh = mesh
        self.dtype = head.dtype
        self.cache = _WeightCache()

    def blocks(self):
        return [self.head.s5a, self.head.s5b, self.head.s5c]

    def forward(self, rois: torch.Tensor, masks=None, quantize: bool = False):
        if masks is not None:
            raise ValueError("the ResNet50 head has no dropout")
        head = self.head
        x = rois.to(self.dtype)
        if quantize:
            if not head.quantize:
                raise ValueError("the int8 head needs a head built with quantize")
            x = x.contiguous()
            for i, blk in enumerate(self.blocks()):
                x = self._int8_block(blk, x, sharded=i > 0)
            x = x.permute(0, 3, 1, 2)
        else:
            x = x.permute(0, 3, 1, 2)  # an NCHW view of channels-last memory, as the full head
            for i, blk in enumerate(self.blocks()):
                x = self._float_block(blk, x, sharded=i > 0)
        x = F.avg_pool2d(x, 7, stride=7).flatten(1).float()
        if quantize:  # the output layers whole, on the gathered vector
            x = all_gather(x, self.mesh, MODEL_AXIS, dim=1)
            wc, wr = (self.cache(w, "whole", lambda t: all_gather(t, self.mesh, MODEL_AXIS, dim=1))
                      for w in (head.dense_class.weight, head.dense_regress.weight))
            return (torch.softmax(F.linear(x, wc, head.dense_class.bias), dim=-1),
                    F.linear(x, wr, head.dense_regress.bias))
        n_cls = head.dense_class.weight.shape[0]
        part = torch.cat([F.linear(x, head.dense_class.weight),
                          F.linear(x, head.dense_regress.weight)], dim=1)
        part = reduce_from_model(part, self.mesh)
        cls = torch.softmax(part[:, :n_cls] + head.dense_class.bias, dim=-1)
        return cls, part[:, n_cls:] + head.dense_regress.bias

    def _input_slice(self, blk) -> slice:
        k = blk.conv2a.weight.shape[1]  # this rank's input channels of conv2a
        return slice(self.mesh.model_index * k, (self.mesh.model_index + 1) * k)

    def _float_block(self, blk: resnet.Bottleneck, x: torch.Tensor, sharded: bool) -> torch.Tensor:
        dt, mesh = self.dtype, self.mesh
        if not sharded:  # the replicated pool: conv2a's channel slice, conv_sc whole
            x = copy_to_model(x, mesh)
        xa = x if sharded else x[:, self._input_slice(blk)]
        part = F.conv2d(xa.to(dt).float(), blk.conv2a.weight.to(dt).float())
        part = reduce_from_model(part, mesh)
        y = part.to(dt) + blk.conv2a.bias.to(dt)[:, None, None]  # the bias once, after the sum
        y = F.relu(blk.bn2a(y))
        y = F.relu(blk.bn2b(blk.conv2b(y)))
        y = copy_to_model(y, mesh)
        w2c = blk.conv2c.weight
        k, bb = _bn_shard(blk.bn2c, dt, w2c, mesh)
        y = F.conv2d(y.to(dt), w2c.to(dt)) + blk.conv2c.bias.to(dt)[:, None, None]
        y = y * k[:, None, None] + bb[:, None, None]
        if blk.project:
            wsc = blk.conv_sc.weight
            k, bb = _bn_shard(blk.bn_sc, dt, wsc, mesh)
            sc = F.conv2d(x.to(dt), wsc.to(dt)) + blk.conv_sc.bias.to(dt)[:, None, None]
            sc = sc * k[:, None, None] + bb[:, None, None]
        else:
            sc = x
        return F.relu(y + sc)

    def _int8_block(self, blk: resnet.Bottleneck, x: torch.Tensor, sharded: bool) -> torch.Tensor:
        dt, mesh = x.dtype, self.mesh
        if sharded:  # this rank's channels; the scale is the whole sample's
            xq_local, xq_full = _quantize_sharded(x, mesh), None
        else:  # the replicated pool: conv_sc reads it whole, conv2a its channel slice
            xq_full = quant.quantize_rows(x)
            xq_local = quant.Quantized(xq_full.q[..., self._input_slice(blk)].contiguous(),
                                       xq_full.scale)
        n, h, w, c = xq_local.q.shape
        wq2a = self.cache(blk.conv2a.weight, "int8", lambda w: _quantize_sharded(
            quant.conv_weight_rows(w.float()), mesh))
        y = _row_parallel_int8(
            quant.Quantized(xq_local.q.reshape(n * h * w, c), xq_local.scale),
            wq2a, blk.conv2a.bias, h * w, mesh,
            bn=blk.bn2a.affine(dt), relu=True,
        ).reshape(n, h, w, -1)
        sc = (quant.int8_conv(xq_full, blk.conv_sc.weight, blk.conv_sc.bias,
                              bn=_bn_shard(blk.bn_sc, dt, blk.conv_sc.weight, mesh))
              if blk.project else x)
        y = blk.conv2b.int8(y, bn=blk.bn2b.affine(dt), relu=True)
        w2c = blk.conv2c.weight
        return quant.int8_conv(y, w2c, blk.conv2c.bias, bn=_bn_shard(blk.bn2c, dt, w2c, mesh),
                               residual=sc, relu=True)


class TPVGG16Head(nn.Module):
    """The VGG16 dense head over the model axis (see the module doc)."""

    def __init__(self, head: vgg.VGG16RoIHead, mesh: Mesh):
        super().__init__()
        self.head = head
        self.mesh = mesh
        self.dtype = head.dtype
        self.cache = _WeightCache()

    def forward(self, rois: torch.Tensor, masks=None, quantize: bool = False):
        dt, head, mesh = self.dtype, self.head, self.mesh
        w1, b1, w2 = head.fc1.weight, head.fc1.bias, head.fc2.weight  # (fc_dim / M, 25088) ...
        x = rois.reshape(rois.shape[0], -1)
        if quantize:
            if not head.quantize or masks is not None:
                raise ValueError("the int8 head needs a head built with quantize and no dropout")
            h = quant.int8_dense(x.to(dt), w1, b1, relu=True)
            wq2 = self.cache(w2, "int8", lambda w: _quantize_sharded(w.float().contiguous(), mesh))
            y = _row_parallel_int8(_quantize_sharded(h, mesh), wq2, head.fc2.bias, 1, mesh,
                                   relu=True)
        else:
            m1, m2 = masks if masks is not None else (None, None)
            if m1 is not None:  # fc1's mask, cut to this rank's columns
                n = w1.shape[0]
                m1 = m1[:, mesh.model_index * n:(mesh.model_index + 1) * n]
            x = copy_to_model(x, mesh)
            h = vgg.dropout(F.relu(F.linear(x.to(dt), w1.to(dt)) + b1.to(dt)), m1)
            part = reduce_from_model(F.linear(h.float(), w2.to(dt).float()), mesh)
            y = vgg.dropout(F.relu(part.to(dt) + head.fc2.bias.to(dt)), m2)  # the bias once
        y = y.float()
        return torch.softmax(head.dense_class(y), dim=-1), head.dense_regress(y)
