"""Tensor-parallel RoI heads: the Megatron split of ``parallel/mesh.py``'s
rules, float and int8, built from a full head and a mesh.

A head built here holds this rank's shards (``shard_state_dict``) and runs
where the full head would (``FasterRCNN.roi_heads(..., head=)``), with the
same outputs on every rank of the model axis.  Its input, the RoI pool, is
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
all-reduced, the bias once, ReLU; the output layers replicated.

Float: a row-parallel layer's partials are float32 products of the
compute-type values (exact products, float32 sums), all-reduced in float32
and rounded to the compute type once, where the single device rounds its
one product once.  Only the order of the float32 sums differs, so the head
is held to the single device by tolerance.  All-reducing bf16 partials
instead would round each rank's partial to bf16 before the sum: up to M
roundings of 2^-9 relative, where the single device has one.

Int8: bit-equal to the single-device int8 head.  A quantization scale over
a row that the model axis splits (a sharded activation; a row-parallel
layer's weight rows, quantized once when the head is built) is the
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

import torch
import torch.nn.functional as F

from radnet_torch.models import resnet, vgg
from radnet_torch.ops import quant
from radnet_torch.parallel.collectives import all_gather, all_reduce
from radnet_torch.parallel.mesh import MODEL_AXIS, Mesh, make_param_shardings, shard_state_dict


def build_tp_head(head, mesh: Mesh):
    """The tensor-parallel counterpart of ``head`` on ``mesh``'s model axis,
    or None where the axis has one rank or no parameter shards (a warning is
    printed then, as the JAX package prints it).  Raises on a head whose
    shardable parameters shard only in part."""
    if mesh.model == 1:
        return None
    state = {f"head.{k}": v for k, v in head.state_dict().items()}
    dims = make_param_shardings(state, mesh.model, warn_label="serving")
    sharded = {k for k, d in dims.items() if d is not None}
    if not sharded:
        return None
    ruled = {k for k, d in make_param_shardings(state, 1).items() if d is not None}
    if sharded != ruled:
        raise ValueError(f"the head shards only in part over a model axis of {mesh.model}: "
                         f"{sorted(ruled - sharded)[:4]} do not divide it")
    shards = shard_state_dict(state, mesh.model, mesh.model_index)
    if isinstance(head, resnet.ResNet50RoIHead):
        return TPResNet50Head(head, shards, mesh)
    if isinstance(head, vgg.VGG16RoIHead):
        return TPVGG16Head(head, shards, mesh)
    raise TypeError(f"no tensor-parallel form of {type(head).__name__}")


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


class _Block:
    """One bottleneck's shards: conv2a's input channels, conv2c's (and
    conv_sc's) output channels; conv2b and the batch norms stay the full
    block's.  ``quantize``: also conv2a's weight rows in int8, with the
    whole rows' scales, once (a call then pays no all-reduce for them)."""

    def __init__(self, blk: resnet.Bottleneck, shards: dict, prefix: str, mesh: Mesh,
                 quantize: bool):
        self.blk = blk
        self.w2a = shards[f"{prefix}.conv2a.weight"]
        self.wq2a = (_quantize_sharded(quant.conv_weight_rows(self.w2a.float()), mesh)
                     if quantize else None)
        self.b2a = shards[f"{prefix}.conv2a.bias"]
        self.w2c = shards[f"{prefix}.conv2c.weight"]
        self.b2c = shards[f"{prefix}.conv2c.bias"]
        self.project = blk.project
        if self.project:
            self.wsc = shards[f"{prefix}.conv_sc.weight"]
            self.bsc = shards[f"{prefix}.conv_sc.bias"]
        n = self.w2c.shape[0]  # this rank's output channels
        self.out = slice(mesh.model_index * n, (mesh.model_index + 1) * n)
        k = self.w2a.shape[1]  # this rank's input channels of conv2a
        self.inp = slice(mesh.model_index * k, (mesh.model_index + 1) * k)

    def bn_shard(self, bn, dt):
        """A column-parallel layer's batch norm: the full ``(k, b)``, cut."""
        k, b = bn.affine(dt)
        return k[self.out], b[self.out]


class TPResNet50Head:
    """The ResNet50 stage-5 head over the model axis (see the module doc)."""

    def __init__(self, head: resnet.ResNet50RoIHead, shards: dict, mesh: Mesh):
        self.head = head
        self.mesh = mesh
        self.dtype = head.dtype
        self.blocks = [_Block(getattr(head, n), shards, f"head.{n}", mesh, head.quantize)
                       for n in ("s5a", "s5b", "s5c")]
        self.wc = shards["head.dense_class.weight"]  # (classes, 2048 / M)
        self.wr = shards["head.dense_regress.weight"]

    def __call__(self, rois: torch.Tensor, masks=None, quantize: bool = False):
        if masks is not None:
            raise ValueError("the ResNet50 head has no dropout")
        x = rois.to(self.dtype)
        if quantize:
            if not self.head.quantize:
                raise ValueError("the int8 head needs a head built with quantize")
            x = x.contiguous()
            for i, b in enumerate(self.blocks):
                x = self._int8_block(b, x, sharded=i > 0)
            x = x.permute(0, 3, 1, 2)
        else:
            x = x.permute(0, 3, 1, 2)  # an NCHW view of channels-last memory, as the full head
            for i, b in enumerate(self.blocks):
                x = self._float_block(b, x, sharded=i > 0)
        x = F.avg_pool2d(x, 7, stride=7).flatten(1).float()
        if quantize:  # the output layers whole, on the gathered vector
            x = all_gather(x, self.mesh, MODEL_AXIS, dim=1)
            return torch.softmax(self.head.dense_class(x), dim=-1), self.head.dense_regress(x)
        n_cls = self.wc.shape[0]
        part = torch.cat([F.linear(x, self.wc), F.linear(x, self.wr)], dim=1)
        part = all_reduce(part, self.mesh, MODEL_AXIS)
        cls = torch.softmax(part[:, :n_cls] + self.head.dense_class.bias, dim=-1)
        return cls, part[:, n_cls:] + self.head.dense_regress.bias

    def _float_block(self, b: _Block, x: torch.Tensor, sharded: bool) -> torch.Tensor:
        dt, blk = self.dtype, b.blk
        xa = x if sharded else x[:, b.inp]
        part = F.conv2d(xa.to(dt).float(), b.w2a.to(dt).float())
        part = all_reduce(part, self.mesh, MODEL_AXIS)
        y = part.to(dt) + b.b2a.to(dt)[:, None, None]  # the bias once, after the sum
        y = F.relu(blk.bn2a(y))
        y = F.relu(blk.bn2b(blk.conv2b(y)))
        k, bb = b.bn_shard(blk.bn2c, dt)
        y = F.conv2d(y.to(dt), b.w2c.to(dt)) + b.b2c.to(dt)[:, None, None]
        y = y * k[:, None, None] + bb[:, None, None]
        if b.project:
            k, bb = b.bn_shard(blk.bn_sc, dt)
            sc = F.conv2d(x.to(dt), b.wsc.to(dt)) + b.bsc.to(dt)[:, None, None]
            sc = sc * k[:, None, None] + bb[:, None, None]
        else:
            sc = x
        return F.relu(y + sc)

    def _int8_block(self, b: _Block, x: torch.Tensor, sharded: bool) -> torch.Tensor:
        dt, blk = x.dtype, b.blk
        if sharded:  # this rank's channels; the scale is the whole sample's
            xq_local, xq_full = _quantize_sharded(x, self.mesh), None
        else:  # the replicated pool: conv_sc reads it whole, conv2a its channel slice
            xq_full = quant.quantize_rows(x)
            xq_local = quant.Quantized(xq_full.q[..., b.inp].contiguous(), xq_full.scale)
        n, h, w, c = xq_local.q.shape
        y = _row_parallel_int8(
            quant.Quantized(xq_local.q.reshape(n * h * w, c), xq_local.scale),
            b.wq2a, b.b2a, h * w, self.mesh,
            bn=blk.bn2a.affine(dt), relu=True,
        ).reshape(n, h, w, -1)
        sc = (quant.int8_conv(xq_full, b.wsc, b.bsc, bn=b.bn_shard(blk.bn_sc, dt))
              if b.project else x)
        y = blk.conv2b.int8(y, bn=blk.bn2b.affine(dt), relu=True)
        return quant.int8_conv(y, b.w2c, b.b2c, bn=b.bn_shard(blk.bn2c, dt), residual=sc, relu=True)


class TPVGG16Head:
    """The VGG16 dense head over the model axis (see the module doc)."""

    def __init__(self, head: vgg.VGG16RoIHead, shards: dict, mesh: Mesh):
        self.head = head
        self.mesh = mesh
        self.dtype = head.dtype
        self.w1 = shards["head.fc1.weight"]  # (fc_dim / M, 25088)
        self.b1 = shards["head.fc1.bias"]
        self.w2 = shards["head.fc2.weight"]  # (fc_dim, fc_dim / M)
        # fc2's weight rows in int8 once, with the whole rows' scales
        self.wq2 = _quantize_sharded(self.w2.float().contiguous(), mesh) if head.quantize else None

    def __call__(self, rois: torch.Tensor, masks=None, quantize: bool = False):
        if masks is not None:
            raise ValueError("the tensor-parallel head runs deterministic (no dropout masks)")
        dt, head = self.dtype, self.head
        x = rois.reshape(rois.shape[0], -1)
        if quantize:
            if not head.quantize:
                raise ValueError("the int8 head needs a head built with quantize")
            h = quant.int8_dense(x.to(dt), self.w1, self.b1, relu=True)
            y = _row_parallel_int8(_quantize_sharded(h, self.mesh), self.wq2, head.fc2.bias, 1,
                                   self.mesh, relu=True)
        else:
            h = F.relu(F.linear(x.to(dt), self.w1.to(dt)) + self.b1.to(dt))
            part = all_reduce(F.linear(h.float(), self.w2.to(dt).float()), self.mesh, MODEL_AXIS)
            y = F.relu(part.to(dt) + head.fc2.bias.to(dt))  # the bias once, after the sum
        y = y.float()
        return torch.softmax(head.dense_class(y), dim=-1), head.dense_regress(y)
