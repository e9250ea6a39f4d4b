"""The port's drawing of detections against OpenCV and radnet_tpu.

``radnet_torch.cli.common`` draws without OpenCV: ``draw_rectangle`` must
put every pixel where ``cv2.rectangle`` puts it (LINE_8, at the thicknesses
the CLIs use and filled), and ``draw_detections`` every pixel where the JAX
package's ``draw_detections`` puts it, its ``class: percent`` labels drawn
from the committed glyph table.  The table was drawn with one cv2 version;
the pixel tests fail, naming both, under another.  Two witnesses (the
square 8-px band the port drew before, and the blend without its rounding)
must fail the same comparisons.
"""

import os
import sys

import cv2
import numpy as np
import pytest
import torch

from radnet_torch.cli import common
from radnet_tpu.cli import common as jcommon

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
import make_label_glyphs  # noqa: E402

torch.set_num_threads(1)

H, W = 60, 80
TABLE_CHARS = [chr(c) for c in make_label_glyphs.CODE_POINTS]


@pytest.fixture(scope="module")
def same_cv2():
    """The table's pixels are the cv2 that drew it; the installed one must
    be that version for a comparison of pixels to mean anything."""
    _, _, drawn_with = common.glyph_table()
    assert drawn_with == cv2.__version__, (
        f"the label glyph table was drawn with cv2 {drawn_with}, the installed cv2 is "
        f"{cv2.__version__}: rebuild it with scripts/make_label_glyphs.py")


def random_boxes(rng, n):
    """``n`` boxes with corners up to 30 px off every edge; every 10th has
    x1 = x2, every 13th y1 = y2, every 5th its corners swapped."""
    for i in range(n):
        x1, x2 = (int(v) for v in rng.integers(-30, W + 30, 2))
        y1, y2 = (int(v) for v in rng.integers(-30, H + 30, 2))
        if i % 10 == 0:
            x2 = x1
        if i % 13 == 0:
            y2 = y1
        if i % 5 == 0:
            x1, y1, x2, y2 = x2, y2, x1, y1
        yield x1, y1, x2, y2


def noise(rng):
    return rng.integers(0, 256, (H, W, 3), dtype=np.uint8)


def rectangles_differ(draw, thickness, seed=0, n=300) -> int:
    """Boxes of ``random_boxes`` where ``draw`` and ``cv2.rectangle``
    disagree on any pixel of a noise image."""
    rng = np.random.default_rng(seed)
    bad = 0
    for x1, y1, x2, y2 in random_boxes(rng, n):
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        img = noise(rng)
        want = cv2.rectangle(img.copy(), (x1, y1), (x2, y2), color, thickness)
        got = draw(img.copy(), x1, y1, x2, y2, color, thickness)
        bad += int((got != want).any())
    return bad


@pytest.mark.parametrize("thickness", [1, 2, 3, 4, 5, 8, -1])
def test_draw_rectangle_matches_cv2(thickness):
    assert rectangles_differ(common.draw_rectangle, thickness) == 0


def test_disc_rows_at_the_clis_thicknesses():
    """The corner discs read off cv2 (half-widths by row offset)."""
    assert common._disc_rows(1) == {0: 1, 1: 0, -1: 0}
    assert common._disc_rows(2) == {0: 2, 1: 1, -1: 1, 2: 0, -2: 0}
    assert common._disc_rows(4) == {0: 4, 1: 3, -1: 3, 2: 3, -2: 3, 3: 2, -3: 2, 4: 0, -4: 0}


def square_band(img, x1, y1, x2, y2, color, thickness=8):
    """The outline the port drew before: four bands ``thickness`` px wide,
    square corners."""
    h, w = img.shape[:2]
    lo, hi = thickness // 2, thickness - thickness // 2
    xa, xb = sorted((x1, x2))
    ya, yb = sorted((y1, y2))
    for r0, r1, c0, c1 in ((ya - lo, ya + hi, xa - lo, xb + hi), (yb - lo, yb + hi, xa - lo, xb + hi),
                           (ya - lo, yb + hi, xa - lo, xa + hi), (ya - lo, yb + hi, xb - lo, xb + hi)):
        r0, r1, c0, c1 = max(r0, 0), min(r1, h), max(c0, 0), min(c1, w)
        if r0 < r1 and c0 < c1:
            img[r0:r1, c0:c1] = color
    return img


def test_the_square_band_fails_the_comparison():
    assert rectangles_differ(square_band, 8, n=50) > 25


def test_put_text_matches_cv2(same_cv2):
    """300 strings of the table's characters, 1-11 long, on noise, black or
    a random colour, origins off every edge."""
    rng = np.random.default_rng(1)
    for i in range(300):
        text = "".join(rng.choice(TABLE_CHARS, int(rng.integers(1, 12))))
        color = (0, 0, 0) if i % 2 else tuple(int(v) for v in rng.integers(0, 256, 3))
        org = (int(rng.integers(-60, W + 10)), int(rng.integers(-10, H + 30)))
        img = noise(rng)
        want = cv2.putText(img.copy(), text, org, cv2.FONT_HERSHEY_DUPLEX, 1, color, 1)
        got = common.put_text(img.copy(), text, org, color)
        assert (got != want).sum() == 0, (text, org, color)


def test_text_size_matches_cv2(same_cv2):
    rng = np.random.default_rng(2)
    for _ in range(2000):
        text = "".join(rng.choice(TABLE_CHARS, int(rng.integers(1, 16))))
        assert common.text_size(text) == cv2.getTextSize(text, cv2.FONT_HERSHEY_COMPLEX, 1, 1), text


def test_every_glyph_draws_as_cv2(same_cv2):
    for ch in TABLE_CHARS:
        img = np.full((H, W, 3), 200, np.uint8)
        want = cv2.putText(img.copy(), ch, (20, 40), cv2.FONT_HERSHEY_DUPLEX, 1, (0, 0, 0), 1)
        assert (common.put_text(img.copy(), ch, (20, 40), (0, 0, 0)) == want).all(), repr(ch)


NAMES = ["boat", "human", "other", "båt", "människa", "Ålesund ÿ", "bg"]
PROBS = [0.0, 0.29, 0.999, 1.0]


def detection(rng, x1, y1, x2=None, y2=None):
    return {"x1": x1, "y1": y1,
            "x2": int(rng.integers(x1, W + 10)) if x2 is None else x2,
            "y2": int(rng.integers(y1, H + 10)) if y2 is None else y2,
            "class": str(rng.choice(NAMES)), "prob": float(rng.choice(PROBS + [rng.random()]))}


def scenes(seed):
    """(name, detections) on a noise image: labels clipped at the top, the
    left and the right, overlapping boxes, and a random crowd."""
    rng = np.random.default_rng(seed)
    yield "top", [detection(rng, 20, 3), detection(rng, 40, 12)]
    yield "left", [detection(rng, -8, 30), detection(rng, 2, 50)]
    yield "right", [detection(rng, W - 30, 35), detection(rng, W - 6, 20)]
    yield "overlap", [detection(rng, 10, 30, 50, 55), detection(rng, 15, 34, 45, 58),
                      detection(rng, 18, 38, 70, 59)]
    yield "crowd", [detection(rng, int(rng.integers(-10, W)), int(rng.integers(-5, H + 5)))
                    for _ in range(6)]
    yield "probs", [dict(detection(rng, 5 + 18 * k, 28), prob=p) for k, p in enumerate(PROBS)]


SCENES = [name for name, _ in scenes(0)]


def detections_differ(seed, name) -> int:
    """Pixels where the port's draw_detections and the JAX package's differ
    on the scene ``name`` over a seeded noise image."""
    dets = dict(scenes(seed))[name]
    img = noise(np.random.default_rng(seed + 100))
    want = jcommon.draw_detections(img.copy(), dets)
    got = common.draw_detections(img.copy(), dets)
    return int((got != want).any(axis=-1).sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", SCENES)
def test_draw_detections_matches_jax(same_cv2, name, seed):
    assert detections_differ(seed, name) == 0


def test_draw_detections_in_colour_matches_jax(same_cv2):
    rng = np.random.default_rng(3)
    for name, dets in scenes(3):
        img = noise(rng)
        want = jcommon.draw_detections(img.copy(), dets, (28, 26, 228))
        assert (common.draw_detections(img.copy(), dets, (28, 26, 228)) == want).all(), name


def blend_without_rounding(dst, a, color):
    return (dst * (255 - a) + color * a) // 255


@pytest.mark.parametrize("witness", ["square_band", "blend_without_rounding"])
def test_the_witnesses_fail_the_comparison(same_cv2, monkeypatch, witness):
    """Black text on the white box blends alike either way, so the blend's
    witness shows where labels leave their box, over all scenes."""
    if witness == "square_band":
        monkeypatch.setattr(common, "draw_rectangle", square_band)
    else:
        monkeypatch.setattr(common, "_blend", blend_without_rounding)
    differ = [detections_differ(seed, name) for seed in (0, 1, 2) for name in SCENES]
    assert sum(differ) > 0 and sum(d > 0 for d in differ) >= 3
    monkeypatch.undo()
    assert not any(detections_differ(seed, name) for seed in (0, 1, 2) for name in SCENES)


def test_a_blend_without_rounding_fails_put_text(same_cv2, monkeypatch):
    img = noise(np.random.default_rng(4))
    want = cv2.putText(img.copy(), "människa: 99", (2, 30), cv2.FONT_HERSHEY_DUPLEX, 1, (0, 0, 0), 1)
    assert (common.put_text(img.copy(), "människa: 99", (2, 30), (0, 0, 0)) == want).all()
    monkeypatch.setattr(common, "_blend", blend_without_rounding)
    assert (common.put_text(img.copy(), "människa: 99", (2, 30), (0, 0, 0)) != want).any()


def test_a_character_outside_the_table_raises():
    with pytest.raises(ValueError, match="U\\+4E2D"):
        common.text_size("中: 99")
    with pytest.raises(SystemExit, match="'中'.*'boat中'"):
        common.require_drawable({"bg": 2, "human": 1, "boat中": 0})
    common.require_drawable({"bg": 2, "båt": 0, "människa": 1})


class _StopBeforePanels:
    """A loaded model whose class mapping has a character outside the
    table, and which fails the test if anything predicts with it."""

    def __init__(self, mapping):
        from radnet_torch.config import Config

        self.C = Config(class_mapping=mapping)

    def __getattr__(self, name):
        raise AssertionError(f"the run reached {name} before stopping")


@pytest.mark.parametrize("cli", ["predict", "test"])
def test_a_class_outside_the_table_stops_the_cli(cli, tmp_path, monkeypatch):
    import radnet_torch.inference
    from radnet_torch.cli import predict as tpredict
    from radnet_torch.cli import test as ttest

    mapping = {"boat": 0, "中国": 1, "bg": 2}
    monkeypatch.setattr(radnet_torch.inference, "load_radnet",
                        lambda *a, **k: _StopBeforePanels(mapping))
    argv = ["--models-path", str(tmp_path), "--model-name", "m", "--device", "cpu"]
    if cli == "predict":
        main, argv = tpredict.main, argv + ["--scan-data-path", str(tmp_path / "missing")]
    else:
        main, argv = ttest.main, argv + ["--test-annot", str(tmp_path / "missing.csv")]
    with pytest.raises(SystemExit, match="'中'.*'中国'"):
        main(argv)
    assert not any(tmp_path.iterdir())  # no panel read, nothing written


def test_the_table_rebuilds_byte_for_byte(same_cv2, tmp_path):
    out = tmp_path / "glyphs.npz"
    make_label_glyphs.write_npz(str(out), make_label_glyphs.build_table())
    with open(common.LABEL_GLYPHS, "rb") as f:
        assert out.read_bytes() == f.read()
