"""The train steps of both schedules, and the eval step.

The joint step, with no read back to the host:

  photometric augmentation + centring -> trunk (once) -> RPN heads
    -> RPN losses -> proposals from the detached RPN outputs (decode + NMS)
    -> second-stage targets and the balanced RoI sample
    -> RoI pooling + detector head -> detector losses
    -> one backward of the summed loss -> one Adam update.

This is "approximate joint training": proposals come from the RPN before
the update, and one optimizer updates the shared trunk once with the summed
loss.  With the trunk frozen, the feature map is detached, so no backward
runs through the trunk; with it trainable, the detector loss reaches the
trunk through the RoI-pool gradient (``ops/roi_align.py``).  The
alternating step (:func:`make_alternating_train_step`) is the JAX package's
reference-exact schedule: an RPN update, proposals from the updated RPN,
then a detector update with a second Adam state.

Random choices are a :class:`StepDraws` per step, drawn by :func:`draw_step`
from a ``torch.Generator`` on the device.

On a mesh (``state.mesh``, ``parallel/mesh.py``) each rank runs its data
index's tiles of the batch with its rows of the whole batch's draws
(:func:`rank_draws`), through the tensor-parallel head where the model axis
splits it (``state.tp_head``).  Each loss is its share of the whole batch's
ratio of sums: the denominators are summed over the data axis first, as
constants, then the gradients are summed over it, and the replicated
parameters' are made one over the model axis
(``collectives.all_reduce_grads``).  The metrics are the whole batch's, and
so is the alternating schedule's gate, which stays on the device.

:func:`make_train_bundle` is the JAX package's ``make_train_bundle``: K
joint steps with the trajectory of K single steps, for one host call.  On a
CUDA device it is one CUDA graph that holds the K steps, captured at the
first call and replayed at every call after it; on the CPU it runs the K
steps one after another.  On a mesh it runs K single steps too: two ranks
sharing a card talk over gloo, whose collectives a graph cannot capture,
and a capture over NCCL across cards cannot be measured on the one-card
host (ROADMAP Held C item 1).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from radnet_torch import losses
from radnet_torch.config import Config, feature_extent
from radnet_torch.data.pipeline import preprocess_on_device
from radnet_torch.engine.train_state import PhaseAdams, TrainState
from radnet_torch.models import vgg
from radnet_torch.models.detector import FasterRCNN
from radnet_torch.ops import augment_device, cuda_kernels, nms
from radnet_torch.ops.anchors import feature_anchors_xywh, image_anchors_xyxy
from radnet_torch.ops.proposals import decode_proposals
from radnet_torch.ops.targets import proposal_targets, rpn_targets, subset_bits
from radnet_torch.parallel.collectives import all_reduce, all_reduce_grads
from radnet_torch.parallel.mesh import DATA_AXIS

METRIC_KEYS = ("loss_rpn_cls", "loss_rpn_regr", "loss_detector_cls", "loss_detector_regr",
               "total_loss", "detector_acc", "mean_overlapping_bboxes")


@dataclasses.dataclass
class StepDraws:
    """The random inputs of one step: the subsample's random words ``(B,
    N)`` int32 (N = H * W * A anchors), the RoI sample's uniforms ``(B,
    post_nms_top_n)``, the photometric draws (None: no augmentation), and
    the VGG16 head's two dropout masks, bool ``(B * n_rois, vgg_fc_dim)``
    with True kept (None: the ResNet50 head, which has no dropout)."""

    rpn_pos_bits: torch.Tensor
    rpn_neg_bits: torch.Tensor
    roi_pos_u: torch.Tensor
    roi_neg_u: torch.Tensor
    photometric: augment_device.PhotometricDraws | None = None
    head_masks: tuple[torch.Tensor, torch.Tensor] | None = None

    def to(self, device) -> "StepDraws":
        photo = None if self.photometric is None else self.photometric.to(device)
        masks = None if self.head_masks is None else tuple(m.to(device) for m in self.head_masks)
        return StepDraws(self.rpn_pos_bits.to(device), self.rpn_neg_bits.to(device),
                         self.roi_pos_u.to(device), self.roi_neg_u.to(device), photo, masks)


def draw_step(gen: torch.Generator, config: Config, b: int, device,
              photometric: bool = True) -> StepDraws:
    """One step's draws from ``gen`` (a generator on ``device``)."""
    n = config.feat_size * config.feat_size * config.n_anchors
    hi = 1 << subset_bits(n)[1]
    p = config.post_nms_top_n

    def bits():
        return torch.randint(0, hi, (b, n), generator=gen, device=device, dtype=torch.int32)

    draws = StepDraws(bits(), bits(), torch.rand((b, p), generator=gen, device=device),
                      torch.rand((b, p), generator=gen, device=device))
    if (photometric and config.augment_photometric_on_device
            and (config.use_brightness or config.use_noise)):
        s = config.canvas_size
        draws.photometric = augment_device.draw_photometric(
            gen, b, s, s, 3, augment_device.grey_mode(config), device)
    if config.network == "vgg16":
        shape = (b * config.n_rois, config.vgg_fc_dim)
        draws.head_masks = tuple(torch.rand(shape, generator=gen, device=device) < vgg.KEEP_PROB
                                 for _ in range(2))
    return draws


def rank_draws(draws: StepDraws, mesh) -> StepDraws:
    """This rank's rows of the whole batch's draws: its data index's tiles,
    and their RoIs' rows of the dropout masks (``mesh`` None: all)."""
    if mesh is None or mesh.data == 1:
        return draws
    b = draws.rpn_pos_bits.shape[0] // mesh.data
    lo, hi = mesh.data_index * b, (mesh.data_index + 1) * b
    photo = draws.photometric
    if photo is not None:
        photo = dataclasses.replace(photo, **{
            f.name: getattr(photo, f.name)[lo:hi] for f in dataclasses.fields(photo)
            if isinstance(getattr(photo, f.name), torch.Tensor)})
    masks = None
    if draws.head_masks is not None:
        r = draws.head_masks[0].shape[0] // (b * mesh.data)  # RoIs a tile
        masks = tuple(m[lo * r:hi * r] for m in draws.head_masks)
    return StepDraws(draws.rpn_pos_bits[lo:hi], draws.rpn_neg_bits[lo:hi],
                     draws.roi_pos_u[lo:hi], draws.roi_neg_u[lo:hi], photo, masks)


def _whole_batch(mesh, *local: torch.Tensor):
    """The whole batch's sums of these sums over this rank's tiles, one
    all-reduce over the data axis, as constants; None off a data-parallel
    mesh, where each loss takes its own."""
    if mesh is None or mesh.data == 1:
        return None
    return all_reduce(torch.stack([v.detach().float() for v in local]), mesh, DATA_AXIS).unbind()


@dataclasses.dataclass
class StepConstants:
    """Device tensors every step reads, uploaded once: an upload from
    pageable memory waits for the card."""

    img_anchors: torch.Tensor  # (H, W, A, 4) xyxy canvas px
    feat_anchors: torch.Tensor  # (H, W, A, 4) xywh feature units
    std_scaling: torch.Tensor  # () float32
    regr_std: torch.Tensor  # (4,) float32


def step_constants(config: Config, device) -> StepConstants:
    f = config.feat_size
    scales = tuple(config.anchor_box_scales)
    ratios = tuple(tuple(r) for r in config.anchor_box_ratios)

    def up(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    return StepConstants(
        up(image_anchors_xyxy(f, f, scales, ratios, config.rpn_stride)),
        up(feature_anchors_xywh(f, f, scales, ratios, config.rpn_stride)),
        up(config.std_scaling), up(config.classifier_regr_std))


def _augment_and_preprocess(config: Config, images: torch.Tensor, draws: StepDraws,
                            deterministic: bool) -> torch.Tensor:
    """Photometric augmentation (training, uint8 canvases) then centring."""
    if not deterministic and draws.photometric is not None and images.dtype == torch.uint8:
        images = augment_device.photometric_augment(
            images, draws.photometric, augment_device.grey_mode(config),
            use_brightness=config.use_brightness, use_noise=config.use_noise,
        ).to(torch.uint8)  # integer-valued 0..255
    return preprocess_on_device(images)


def _rpn_targets(config: Config, batch: dict, draws: StepDraws, consts: StepConstants,
                 sample_valid: torch.Tensor):
    """The RPN's targets; padded samples contribute nothing."""
    valid_wh = batch["valid_wh"]
    tg = rpn_targets(
        batch["gt_boxes"], batch["gt_mask"], valid_wh[:, 0], valid_wh[:, 1],
        consts.img_anchors, draws.rpn_pos_bits, draws.rpn_neg_bits,
        rpn_min_overlap=config.rpn_min_overlap, rpn_max_overlap=config.rpn_max_overlap,
        max_regions=config.rpn_max_regions, std_scaling=config.std_scaling,
        reference_neg_budget=config.rpn_reference_neg_budget,
        fallback_min_iou=config.rpn_fallback_min_iou,
    )
    sv = sample_valid[:, None, None, None]
    return tg.y_rpn_cls * sv, tg.y_rpn_regr * sv


def _rpn_dens(config: Config, rpn_targets_, sample_valid: torch.Tensor, mesh):
    """The whole batch's (RPN class, RPN regression, valid tiles)
    denominators, or None off a data-parallel mesh."""
    y_cls, y_regr = rpn_targets_
    return _whole_batch(mesh, *losses.rpn_denominators(y_cls, y_regr, config.n_anchors),
                        sample_valid.sum())


def _rpn_losses(config: Config, rpn_out, rpn_targets_, dens=None):
    (rpn_cls, rpn_regr), (y_cls, y_regr) = rpn_out, rpn_targets_
    d_cls, d_regr = (None, None) if dens is None else dens[:2]
    return (losses.rpn_loss_cls(y_cls, rpn_cls, config.n_anchors, d_cls),
            losses.rpn_loss_regr(y_regr, rpn_regr, config.n_anchors, d_regr))


def _proposals_and_roi_targets(config: Config, rpn_cls, rpn_regr, batch: dict, draws: StepDraws,
                               consts: StepConstants, sample_valid: torch.Tensor):
    """Proposals from the detached RPN outputs (decode + NMS), then the
    second-stage targets and the balanced RoI sample: (targets, RoI mask)."""
    valid_wh = batch["valid_wh"]
    props = decode_proposals(
        rpn_cls.detach(), rpn_regr.detach(),
        feature_extent(valid_wh[:, 0], config.network),
        feature_extent(valid_wh[:, 1], config.network),
        consts.feat_anchors, std_scaling=consts.std_scaling,
        pre_nms_top_n=config.pre_nms_top_n, post_nms_top_n=config.post_nms_top_n,
        nms_thresh=config.rpn_nms_thresh,
    )
    pt = proposal_targets(
        props.boxes, props.valid, batch["gt_boxes"], batch["gt_classes"], batch["gt_mask"],
        draws.roi_pos_u, draws.roi_neg_u, consts.regr_std,
        n_classes=config.n_classes, n_rois=config.n_rois, stride=config.rpn_stride,
        classifier_min_overlap=config.classifier_min_overlap,
        classifier_max_overlap=config.classifier_max_overlap,
    )
    return pt, pt.roi_valid.float() * sample_valid[:, None]


def _detector_dens(config: Config, pt, roi_mask: torch.Tensor, mesh):
    """The whole batch's (valid RoIs, detector regression) denominators, or
    None off a data-parallel mesh."""
    return _whole_batch(mesh, *losses.detector_denominators(pt.y_regr, config.n_classes - 1,
                                                             roi_mask))


def _detector_losses(model: FasterRCNN, config: Config, fmap, pt, roi_mask, masks,
                     deterministic: bool = False, dens=None, head=None):
    """(class loss, regression loss, accuracy) of the RoI head on the
    sampled RoIs; ``masks``: the head's dropout masks, or None.  A
    ``deterministic`` pass (the eval step) runs the int8 head where the model
    has one, as the JAX package's eval step does; training runs it float.
    ``dens``: the whole batch's :func:`_detector_dens`; ``head``: the
    tensor-parallel head, or None."""
    det_cls, det_regr = model.roi_heads(fmap, pt.rois, masks=masks, quantize=deterministic,
                                        head=head)
    n_rois, d_regr = (None, None) if dens is None else dens
    return (losses.class_loss_cls(pt.y_class, det_cls, roi_mask, n_rois),
            losses.class_loss_regr(pt.y_regr, det_regr, config.n_classes - 1, roi_mask, d_regr),
            losses.detector_accuracy(pt.y_class, det_cls, roi_mask, n_rois))


def _metrics(l_rpn_cls, l_rpn_regr, l_det_cls, l_det_regr, acc, pt, sample_valid,
             mesh=None, rpn_dens=None) -> dict:
    """The step's metrics; on a data-parallel mesh each rank's shares,
    summed over the data axis in one all-reduce (every rank then holds the
    whole batch's)."""
    n_valid = (sample_valid.sum() if rpn_dens is None else rpn_dens[2]).clamp_min(1.0)
    metrics = {
        "loss_rpn_cls": l_rpn_cls, "loss_rpn_regr": l_rpn_regr,
        "loss_detector_cls": l_det_cls, "loss_detector_regr": l_det_regr,
        "total_loss": l_rpn_cls + l_rpn_regr + l_det_cls + l_det_regr, "detector_acc": acc,
        # Positive RoIs per image before sampling.
        "mean_overlapping_bboxes": (pt.n_pos.float() * sample_valid).sum() / n_valid,
    }
    if rpn_dens is None:
        return {k: v.detach() for k, v in metrics.items()}
    shares = torch.stack([metrics[k].detach().float() for k in METRIC_KEYS])
    return dict(zip(METRIC_KEYS, all_reduce(shares, mesh, DATA_AXIS).unbind()))


def compute_losses(model: FasterRCNN, config: Config, batch: dict, draws: StepDraws,
                   consts: StepConstants, deterministic: bool,
                   trunk_frozen: bool = False, mesh=None, head=None) -> tuple[torch.Tensor, dict]:
    """Forward pass and the four losses of one batch of tiles: (total loss,
    metrics as 0-d tensors on the device).  ``deterministic``: no
    augmentation and no dropout.  On a ``mesh``: this rank's tiles and
    draws, its share of the loss, the whole batch's metrics; ``head``: the
    tensor-parallel head, or None."""
    images = _augment_and_preprocess(config, batch["image"], draws, deterministic)
    sample_valid = batch["sample_valid"].float()
    y_rpn = _rpn_targets(config, batch, draws, consts, sample_valid)
    rpn_dens = _rpn_dens(config, y_rpn, sample_valid, mesh)

    fmap = model.features(images)
    if trunk_frozen:
        fmap = fmap.detach()
    rpn_cls, rpn_regr = model.rpn(fmap)
    l_rpn_cls, l_rpn_regr = _rpn_losses(config, (rpn_cls, rpn_regr), y_rpn, rpn_dens)
    pt, roi_mask = _proposals_and_roi_targets(config, rpn_cls, rpn_regr, batch, draws, consts,
                                              sample_valid)
    l_det_cls, l_det_regr, acc = _detector_losses(
        model, config, fmap, pt, roi_mask, None if deterministic else draws.head_masks,
        deterministic, _detector_dens(config, pt, roi_mask, mesh), head)
    metrics = _metrics(l_rpn_cls, l_rpn_regr, l_det_cls, l_det_regr, acc, pt, sample_valid,
                       mesh, rpn_dens)
    return l_rpn_cls + l_rpn_regr + l_det_cls + l_det_regr, metrics


def _grad_sync(state: TrainState, adam):
    """On a mesh, a function that sums ``adam``'s gradients over the data
    axis and then makes the replicated ones one over the model axis
    (``collectives.all_reduce_grads``); off a mesh one that does nothing."""
    if state.mesh is None:
        return lambda: None
    names = {id(p): n for n, p in state.model.named_parameters()}
    replicated = [p for p in adam.params if names[id(p)] not in state.shard_dims]
    return lambda: all_reduce_grads(adam.params, state.mesh, replicated)


def _joint_update(state: TrainState, config: Config, trunk_trainable: bool):
    """``update(batch, draws, gate=None) -> metrics``: the joint step's work
    on the device (losses, backward, the gradients' sums on a mesh, the Adam
    update; ``gate`` a device bool, False moving nothing), without the
    host's step count."""
    consts = step_constants(config, next(state.model.parameters()).device)
    mesh = state.mesh
    sync_grads = _grad_sync(state, state.optimizer)

    def update(batch: dict, draws: StepDraws, gate: torch.Tensor | None = None) -> dict:
        state.optimizer.zero_grad()
        total, metrics = compute_losses(state.model, config, batch, draws, consts, False,
                                        trunk_frozen=not trunk_trainable, mesh=mesh,
                                        head=state.tp_head)
        total.backward()
        sync_grads()
        state.optimizer.step(gate=gate)
        return metrics

    return update


def make_train_step(state: TrainState, config: Config, trunk_trainable: bool | None = None):
    """``step(batch, draws) -> metrics``: one Adam update of ``state`` in
    place.  ``trunk_trainable`` must match the partition the optimizer was
    built with (default ``config.base_net_trainable``).  On a mesh the step
    takes this rank's tiles and :func:`rank_draws`."""
    if trunk_trainable is None:
        trunk_trainable = config.base_net_trainable
    update = _joint_update(state, config, trunk_trainable)

    def train_step(batch: dict, draws: StepDraws) -> dict:
        metrics = update(batch, draws)
        state.step += 1
        return metrics

    return train_step


def make_train_bundle(state: TrainState, config: Config, n_steps: int,
                      trunk_trainable: bool | None = None):
    """``fn(batches, draws_list) -> metrics``: ``n_steps`` joint steps of
    ``state`` in place, step ``k`` on ``batches[k]`` with ``draws_list[k]``,
    as ``n_steps`` calls of :func:`make_train_step`'s step would run them;
    every metric comes back stacked with a leading ``n_steps`` axis, and
    ``state.step`` moves by ``n_steps``.  ``fn._bundle_steps`` is
    ``n_steps``.  The alternating schedule has no bundle, as in the JAX
    package.

    On a CUDA device without a mesh the bundle is a :class:`GraphBundle`:
    one CUDA graph replay a call.  A capture that fails raises; it never
    runs single steps instead.  On the CPU, and on a mesh (``state.mesh``:
    gloo's collectives cannot be captured, and NCCL capture across cards is
    not measured), it runs the ``n_steps`` steps one after another."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    if isinstance(state.optimizer, PhaseAdams) or config.train_schedule != "joint":
        raise ValueError("make_train_bundle runs the joint schedule; the alternating schedule "
                         "runs single steps, as in the JAX package")
    if trunk_trainable is None:
        trunk_trainable = config.base_net_trainable
    update = _joint_update(state, config, trunk_trainable)
    if graph_bundled(state):
        return GraphBundle(state, update, n_steps, next(state.model.parameters()).device)

    def train_bundle(batches: list, draws_list: list) -> dict:
        _check_count(batches, draws_list, n_steps)
        rows = [update(b, d) for b, d in zip(batches, draws_list)]
        state.step += n_steps
        return {k: torch.stack([m[k] for m in rows]) for k in METRIC_KEYS}

    train_bundle._bundle_steps = n_steps
    return train_bundle


def graph_bundled(state: TrainState) -> bool:
    """Whether :func:`make_train_bundle` captures ``state``'s steps as a CUDA
    graph: on a CUDA device without a mesh."""
    return next(state.model.parameters()).device.type == "cuda" and state.mesh is None


def _check_count(batches: list, draws_list: list, n_steps: int) -> None:
    if len(batches) != n_steps or len(draws_list) != n_steps:
        raise ValueError(f"a bundle of {n_steps} steps takes {n_steps} batches and draws, "
                         f"not {len(batches)} and {len(draws_list)}")


def _draw_tensors(d: StepDraws) -> list[torch.Tensor]:
    """The tensors of a StepDraws, in a fixed order."""
    out = [d.rpn_pos_bits, d.rpn_neg_bits, d.roi_pos_u, d.roi_neg_u]
    if d.photometric is not None:
        out += [getattr(d.photometric, f.name) for f in dataclasses.fields(d.photometric)
                if isinstance(getattr(d.photometric, f.name), torch.Tensor)]
    if d.head_masks is not None:
        out += list(d.head_masks)
    return out


def _clone_draws(d: StepDraws) -> StepDraws:
    photo = d.photometric
    if photo is not None:
        photo = dataclasses.replace(photo, **{
            f.name: getattr(photo, f.name).clone() for f in dataclasses.fields(photo)
            if isinstance(getattr(photo, f.name), torch.Tensor)})
    masks = None if d.head_masks is None else tuple(m.clone() for m in d.head_masks)
    return StepDraws(d.rpn_pos_bits.clone(), d.rpn_neg_bits.clone(), d.roi_pos_u.clone(),
                     d.roi_neg_u.clone(), photo, masks)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().view(-1).view(torch.uint8)


class GraphBundle:
    """:func:`make_train_bundle` on a CUDA device: one ``torch.cuda.CUDAGraph``
    that holds ``n_steps`` joint steps.

    It keeps static device buffers: ``n_steps`` batches and ``n_steps``
    :class:`StepDraws`, and the metrics as one ``(n_steps,
    len(METRIC_KEYS))`` float32 table.  A call copies its inputs into them on
    the current stream (so after the uploads that made them), replays the
    graph once and returns a clone of the table's columns, which the next
    replay cannot overwrite.  The draws stay inputs, drawn by the caller in
    the single steps' order.  The Poisson sampler's generator (the draws'
    ``photometric.poisson_generator``) is registered with the graph, so each
    replay takes its numbers from the generator's state at the replay and
    moves it as the ``n_steps`` eager steps would.

    The first call captures.  It first runs one warm-up step on a side
    stream with the Adam update shut (``GatedAdam.step(gate=False)``:
    neither the parameters, the moments nor the count move) to build the
    first-use constants, handles and workspaces that a capture may not
    create, then captures the ``n_steps`` steps (which runs nothing).  The
    generators' states are saved before and restored after both, and the
    call raises unless the parameters, the moments and the count are bit
    for bit as they were.  ``warmup_steps`` (1 after the capture) counts the
    warm-up's step, whose kernels did launch; ``capture_s`` is the first
    call's seconds of warm-up and capture.  The capture's launch counts are
    added on every replay (``cuda_kernels.CapturedLaunches``), and so are
    its ``nms.NMS_STATS`` calls."""

    def __init__(self, state: TrainState, update, n_steps: int, device):
        self.state, self.update, self._bundle_steps = state, update, n_steps
        self.device = device
        self.graph = None
        self.warmup_steps = 0
        self.capture_s = None

    def __call__(self, batches: list, draws_list: list) -> dict:
        _check_count(batches, draws_list, self._bundle_steps)
        if self.graph is None:
            self._capture(batches, draws_list)
        else:
            self._load(batches, draws_list)
        self.graph.replay()
        self.launches.replayed()
        self.state.step += self._bundle_steps
        table = self.table.clone()
        return {k: table[:, i] for i, k in enumerate(METRIC_KEYS)}

    def _flat(self, batches: list, draws_list: list) -> list[torch.Tensor]:
        out = []
        for b, d in zip(batches, draws_list):
            out += [b[k] for k in sorted(b)] + _draw_tensors(d)
        return out

    def _load(self, batches: list, draws_list: list) -> None:
        for b, d, sd in zip(batches, draws_list, self.static_draws):
            if sorted(b) != self.keys:
                raise ValueError(f"a captured bundle takes batches of {self.keys}, not {sorted(b)}")
            gen = None if d.photometric is None else d.photometric.poisson_generator
            if (d.photometric is None) != (sd.photometric is None) or gen is not self.gen:
                raise ValueError("a captured bundle takes draws like those it captured, its "
                                 "Poisson noise from the generator it captured")
        src = self._flat(batches, draws_list)
        if len(src) != len(self.static):
            raise ValueError("a captured bundle takes draws like those it captured")
        for dst, t in zip(self.static, src):
            if t.shape != dst.shape or t.dtype != dst.dtype:
                raise ValueError(f"a captured bundle takes {tuple(dst.shape)} {dst.dtype} here, "
                                 f"not {tuple(t.shape)} {t.dtype}")
            dst.copy_(t, non_blocking=True)

    def _capture(self, batches: list, draws_list: list) -> None:
        t0 = time.perf_counter()
        dev, n = self.device, self._bundle_steps
        self.keys = sorted(batches[0])
        self.static_batches = [{k: b[k].clone() for k in sorted(b)} for b in batches]
        self.static_draws = [_clone_draws(d) for d in draws_list]
        self.static = self._flat(self.static_batches, self.static_draws)
        photo = draws_list[0].photometric
        self.gen = None if photo is None else photo.poisson_generator
        self._load(batches, draws_list)  # checks every step's structure
        gens = [torch.cuda.default_generators[dev.index if dev.index is not None
                                               else torch.cuda.current_device()]]
        if self.gen is not None and self.gen is not gens[0]:
            gens.append(self.gen)
        names = {id(p): name for name, p in self.state.model.named_parameters()}
        moving = {}  # what neither the warm-up nor the capture may move, by name
        for a in self.state.adams():
            moving["Adam's count"] = a.count
            for p, m, v in zip(a.params, a.exp_avg, a.exp_avg_sq):
                moving.update({names[id(p)]: p, f"exp_avg of {names[id(p)]}": m,
                               f"exp_avg_sq of {names[id(p)]}": v})
        before = {k: t.detach().clone() for k, t in moving.items()}
        saved = [g.get_state() for g in gens]

        # Warm-up: one step with the update shut, on a side stream.
        shut = torch.zeros((), dtype=torch.bool, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.update(self.static_batches[0], self.static_draws[0], gate=shut)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.warmup_steps = 1
        for g, st in zip(gens, saved):
            g.set_state(st)

        self.table = torch.zeros((n, len(METRIC_KEYS)), dtype=torch.float32, device=dev)
        graph = torch.cuda.CUDAGraph()
        for g in gens[1:]:  # the default generator is registered by the capture itself
            graph.register_generator_state(g)
        try:
            with cuda_kernels.CapturedLaunches(counters=(nms.NMS_STATS,)) as launches, \
                    torch.cuda.graph(graph, capture_error_mode="thread_local"):
                for k in range(n):
                    m = self.update(self.static_batches[k], self.static_draws[k])
                    self.table[k].copy_(torch.stack([m[key].float() for key in METRIC_KEYS]))
        except Exception as e:
            raise RuntimeError(f"capturing the {n}-step train bundle as a CUDA graph failed "
                               f"(the operation that broke it is in the traceback): {e}") from e
        for g, st in zip(gens, saved):
            g.set_state(st)
        moved = [k for k, t in moving.items() if not torch.equal(_bits(t), _bits(before[k]))]
        if moved:
            raise RuntimeError(f"the train bundle's warm-up or capture moved {len(moved)} of "
                               f"{len(moving)} tensors of the training state: {moved[:8]}")
        self.graph, self.launches = graph, launches
        self.capture_s = time.perf_counter() - t0


def make_alternating_train_step(state: TrainState, config: Config,
                                trunk_trainable: bool | None = None):
    """``step(batch, draws) -> metrics``: one step of the alternating
    schedule on ``state`` (whose optimizer is a
    :class:`~radnet_torch.engine.train_state.PhaseAdams`), in place:

      1. the RPN losses -> backward -> the RPN phase's Adam (trunk + RPN);
      2. proposals from the just-updated parameters -> the RoI sample;
      3. the detector losses, dropout included -> backward -> the
         detector phase's Adam (trunk + head), gated on the device: a batch
         with no valid RoI moves neither the parameters nor that Adam state
         (its count included), and nothing is read back to the host.

    The trunk runs forward twice with a trainable trunk (before and after
    the RPN update; step 3 reuses step 2's features) and once with it
    frozen, since the RPN update then leaves it as it was.  Metrics are
    the JAX package's, the detector's included on a batch with no valid
    RoI."""
    if trunk_trainable is None:
        trunk_trainable = config.base_net_trainable
    consts = step_constants(config, next(state.model.parameters()).device)
    opt, mesh = state.optimizer, state.mesh
    syncs = {id(adam): _grad_sync(state, adam) for adam in (opt.rpn, opt.det)}

    def update(adam, gate=None):
        syncs[id(adam)]()
        adam.step(gate=gate)

    def train_step(batch: dict, draws: StepDraws) -> dict:
        model = state.model
        images = _augment_and_preprocess(config, batch["image"], draws, False)
        sample_valid = batch["sample_valid"].float()
        y_rpn = _rpn_targets(config, batch, draws, consts, sample_valid)
        rpn_dens = _rpn_dens(config, y_rpn, sample_valid, mesh)

        # 1. RPN update.
        opt.rpn.zero_grad()
        fmap = model.features(images)
        if not trunk_trainable:
            fmap = fmap.detach()
        l_rpn_cls, l_rpn_regr = _rpn_losses(config, model.rpn(fmap), y_rpn, rpn_dens)
        (l_rpn_cls + l_rpn_regr).backward()
        update(opt.rpn)

        # 2. Proposals from the updated parameters.
        if trunk_trainable:
            fmap = model.features(images)
        with torch.no_grad():
            rpn_cls, rpn_regr = model.rpn(fmap)
        pt, roi_mask = _proposals_and_roi_targets(config, rpn_cls, rpn_regr, batch, draws, consts,
                                                  sample_valid)

        # 3. Detector update, skipped on the device without a valid RoI in
        # the whole batch.
        opt.det.zero_grad()
        det_dens = _detector_dens(config, pt, roi_mask, mesh)
        l_det_cls, l_det_regr, acc = _detector_losses(model, config, fmap, pt, roi_mask,
                                                      draws.head_masks, dens=det_dens,
                                                      head=state.tp_head)
        (l_det_cls + l_det_regr).backward()
        update(opt.det, gate=(roi_mask.sum() if det_dens is None else det_dens[0]) > 0)
        state.step += 1
        return _metrics(l_rpn_cls, l_rpn_regr, l_det_cls, l_det_regr, acc, pt, sample_valid,
                        mesh, rpn_dens)

    return train_step


def make_step(state: TrainState, config: Config, trunk_trainable: bool | None = None):
    """The train step of ``config.train_schedule``."""
    if config.train_schedule == "alternating":
        return make_alternating_train_step(state, config, trunk_trainable)
    return make_train_step(state, config, trunk_trainable)


def make_eval_step(state: TrainState, config: Config):
    """``step(batch, draws) -> metrics``: losses only, no augmentation (on a
    mesh, as :func:`make_train_step` takes its inputs)."""
    consts = step_constants(config, next(state.model.parameters()).device)

    @torch.no_grad()
    def eval_step(batch: dict, draws: StepDraws) -> dict:
        return compute_losses(state.model, config, batch, draws, consts, True, mesh=state.mesh,
                              head=state.tp_head)[1]

    return eval_step
