"""Port's evaluation ops against the JAX package on the CPU: PSNR / SSIM
(ops/image.py), connected components (ops/components.py) and pixel ROC-AUC
(ops/auc.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import rankdata

from blindshadowremoval_tpu.ops import auc as jax_auc
from blindshadowremoval_tpu.ops import components as jax_cc
from blindshadowremoval_tpu.ops import image as jax_image
from blindshadowremoval_tpu_torch.ops import auc, components
from blindshadowremoval_tpu_torch.ops import image


@pytest.fixture(autouse=True)
def one_thread():
    """These ops are many small tensor ops; across 6 test workers a thread
    pool per op costs more than it saves."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pairs(kind):
    rng = np.random.default_rng(0)
    if kind == "random":
        a = rng.uniform(size=(3, 64, 64, 3)).astype(np.float32)
        b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    else:
        # a structured image (a smooth ramp and a disc) against a shifted,
        # darkened copy: large flat areas, where SSIM's variance cancels
        yy, xx = np.mgrid[:96, :96] / 96.0
        disc = ((yy - 0.5) ** 2 + (xx - 0.4) ** 2 < 0.06).astype(np.float32)
        a = np.stack([0.2 + 0.6 * xx, 0.5 * disc + 0.3, 0.7 - 0.4 * yy],
                     -1)[None].astype(np.float32)
        b = (0.8 * np.roll(a, 3, axis=2)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("kind", ["random", "structured"])
def test_psnr_ssim_match_jax(kind):
    a, b = _pairs(kind)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(image.ssim(ta, tb).numpy(),
                               np.asarray(jax_image.ssim(a, b)), atol=1e-5)
    np.testing.assert_allclose(image.psnr(ta, tb).numpy(),
                               np.asarray(jax_image.psnr(a, b)), atol=1e-5)


def test_ssim_kernel_matches_jax():
    # exp in f32 on both sides; the libraries may round an ulp apart
    np.testing.assert_allclose(image._ssim_kernel().numpy(),
                               np.asarray(jax_image._ssim_kernel()),
                               rtol=0, atol=3e-8)


def test_ssim_psnr_of_identical_images():
    """Identical images: PSNR hits the 1e-12 MSE floor (120 dB), as in JAX,
    and SSIM reads 1 up to the f32 residue of E[x^2] - E[x]^2 over c2
    (2e-5 here; the JAX package's filters sum in another order, 1e-5)."""
    a, _ = _pairs("structured")
    t = torch.from_numpy(a)
    assert float(image.psnr(t, t)[0]) == float(jax_image.psnr(a, a)[0])
    assert abs(float(image.ssim(t, t)[0]) - 1.0) <= 5e-5


def _snake(h=40, w=40):
    """One long 4-connected path: the worst case for propagation."""
    m = np.zeros((h, w), np.float32)
    for r in range(0, h, 4):
        m[r, 1:w - 1] = 1
        c = w - 2 if (r // 4) % 2 == 0 else 1
        m[r:r + 4, c] = 1
    return m


def _masks():
    rng = np.random.default_rng(1)
    out = {f"random{d}": (rng.uniform(size=(48, 56)) < d).astype(np.float32)
           for d in (0.3, 0.45, 0.6)}
    out["snake"] = _snake()
    out["empty"] = np.zeros((32, 32), np.float32)
    return out


MASKS = _masks()


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_label_components_match_jax(name, connectivity):
    m = MASKS[name]
    ours = components.label_components(torch.from_numpy(m),
                                       connectivity=connectivity).numpy()
    theirs = np.asarray(jax_cc.label_components(jnp.asarray(m),
                                                connectivity=connectivity))
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("connectivity", [4, 8])
def test_label_components_match_scipy_partition(connectivity):
    m = MASKS["random0.45"]
    ours = components.label_components(torch.from_numpy(m),
                                       connectivity=connectivity).numpy()
    n, lab, sizes = components.connected_components_host(m, connectivity)
    # the same partition: one port id per scipy label, and back
    fg = m > 0
    pairs = set(zip(ours[fg].tolist(), lab[fg].tolist()))
    assert len(pairs) == n - 1 == len(set(ours[fg].tolist()))
    np.testing.assert_array_equal(
        np.sort(components.component_sizes(torch.from_numpy(ours))
                .numpy()[np.unique(ours[fg])]), np.sort(sizes[1:]))


def test_label_components_batched_equals_per_image():
    ms = np.stack([MASKS[k][:32, :32] for k in sorted(MASKS)])
    labels, iterations = components.label_components_batched(
        torch.from_numpy(ms))
    assert iterations >= 1
    for j, m in enumerate(ms):
        np.testing.assert_array_equal(
            labels[j].numpy(),
            components.label_components(torch.from_numpy(m)).numpy())


@pytest.mark.parametrize("veto", [False, True])
@pytest.mark.parametrize("name", ["random0.3", "random0.6", "snake"])
def test_filter_components_match_jax(name, veto):
    m = MASKS[name]
    rng = np.random.default_rng(2)
    region = (rng.uniform(size=m.shape) < 0.7).astype(np.float32)
    tl = components.label_components(torch.from_numpy(m))
    jl = jax_cc.label_components(jnp.asarray(m))
    kw_t = dict(veto_region=torch.from_numpy(region),
                veto_max_overlap=0.8) if veto else {}
    kw_j = dict(veto_region=jnp.asarray(region),
                veto_max_overlap=jnp.asarray(0.8)) if veto else {}
    ours = components.filter_components(torch.from_numpy(m), tl, 0.45, **kw_t)
    theirs = jax_cc.filter_components(jnp.asarray(m), jl, jnp.asarray(0.45),
                                      **kw_j)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def _rank_auc(labels, scores):
    """The scipy f64 oracle: midranks by rankdata."""
    ranks = rankdata(scores.astype(np.float64))
    pos = labels.sum()
    neg = labels.size - pos
    return (ranks[labels == 1].sum() - pos * (pos + 1) / 2) / (pos * neg)


@pytest.mark.parametrize("zeros", [0.3, 0.6, 0.9])
def test_roc_auc_with_sentinels(zeros):
    """A face-gated map: one tie group of exact zeros covering `zeros` of
    the pixels, and f16-like quantized scores with more ties."""
    rng = np.random.default_rng(int(zeros * 10))
    label = (rng.uniform(size=(96, 96)) < 0.3).astype(np.float32)
    pred = np.round(rng.uniform(size=(96, 96)) + 0.2 * label, 3)
    pred[rng.uniform(size=pred.shape) < zeros] = 0.0
    pred = pred.astype(np.float32)
    ours = float(auc.roc_auc_with_sentinels(torch.from_numpy(label),
                                            torch.from_numpy(pred)))
    theirs = float(jax_auc.roc_auc_with_sentinels(jnp.asarray(label),
                                                  jnp.asarray(pred)))
    lab = np.concatenate([[1.0, 0.0], label.ravel()])
    sco = np.concatenate([[1.0, 0.0], pred.ravel()])
    assert abs(ours - theirs) <= 5e-5
    assert abs(ours - _rank_auc(lab, sco)) <= 1e-6


def test_roc_auc_extremes():
    labels = torch.tensor([0.0, 0.0, 1.0, 1.0])
    assert float(auc.roc_auc(labels, torch.tensor([0.1, 0.2, 0.3, 0.4]))) == 1
    assert float(auc.roc_auc(labels, torch.tensor([0.4, 0.3, 0.2, 0.1]))) == 0
    assert float(auc.roc_auc(labels, torch.zeros(4))) == 0.5
