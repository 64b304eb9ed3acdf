"""Port parity: ``spef_tpu_torch.temporal.pdf_filter`` against
``spef_tpu.temporal.pdf_filter``.

  * ``compute_distance`` (all six metrics), the streaming ``TemporalPDF``
    and ``scan_filter`` on the same random PDF sequences of the flagship's
    sizes (1232 orientation and 1000 position bins, T = 40, the logits a
    random walk, as a video's drift): absolute tolerance 1e-6 on every PDF
    value and distance (float32 on both sides; the sums over the bins run in
    other orders).
  * The port's scan against its own streaming filter, and a batched leading
    dimension against a loop over the sequences: the same 1e-6.
  * ``filter_defaults`` for each dataset family: equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spef_tpu.temporal import pdf_filter as jpf
from spef_tpu_torch.temporal import pdf_filter as pf

METRICS = ("l2", "kl", "js", "hellinger", "tv", "wasserstein")
BINS = (1232, 1000)
T = 40
ATOL = 1e-6


def _pdfs(seed, shape):
    """Sequences of peaked, unnormalized PDFs along axis -2, as a video's
    come: softmax of wide logits that drift from frame to frame (a random
    walk), scaled.  Consecutive frames are 0.05-1 apart in each metric, as
    the filter sees them; two unrelated peaked PDFs are up to 11 apart in
    KL, where float32 keeps only 1e-6 relative."""
    rs = np.random.RandomState(seed)
    logits = rs.randn(*shape[:-2], 1, shape[-1]) * 3.0 + np.cumsum(
        rs.randn(*shape) * 0.3, axis=-2)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True) * 1.7).astype(np.float32)


@pytest.mark.parametrize("n_bins", BINS)
@pytest.mark.parametrize("metric", METRICS)
def test_distance_matches_jax(metric, n_bins):
    seq = _pdfs(0, (T + 1, n_bins))
    a, b = seq[1:], seq[:-1]  # each frame against the one before
    got = pf.compute_distance(torch.from_numpy(a), torch.from_numpy(b), metric)
    want = np.asarray(jpf.compute_distance(jnp.asarray(a), jnp.asarray(b), metric))
    assert got.dtype == torch.float32 and got.shape == (T,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n_bins", BINS)
@pytest.mark.parametrize("metric", METRICS)
def test_filters_match_jax(metric, n_bins):
    """The scan and the streaming filter against JAX's, frame by frame, and
    the port's scan against its own streaming filter."""
    pdfs = _pdfs(2, (T, n_bins))
    n, alpha = 0.8, 16.49
    filt, dist = pf.scan_filter(torch.from_numpy(pdfs), n, alpha, metric)
    jfilt, jdist = jpf.scan_filter(jnp.asarray(pdfs), n, alpha, metric)
    np.testing.assert_allclose(filt.numpy(), np.asarray(jfilt), rtol=0, atol=ATOL)
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=0, atol=ATOL)
    assert dist[0] == 0.0

    mine = pf.TemporalPDF(n=n, alpha=alpha, distance_metric=metric)
    theirs = jpf.TemporalPDF(n=n, alpha=alpha, distance_metric=metric)
    for t in range(T):
        out, d = mine.update_pdf(torch.from_numpy(pdfs[t]))
        jout, jd = theirs.update_pdf(pdfs[t])
        assert isinstance(d, float)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=ATOL)
        assert d == pytest.approx(jd, abs=ATOL)
        np.testing.assert_allclose(out.numpy(), filt[t].numpy(), rtol=0, atol=ATOL)
        assert d == pytest.approx(float(dist[t]), abs=ATOL)


def test_first_frame_is_the_normalized_pdf():
    pdfs = torch.from_numpy(_pdfs(3, (3, 1000)))
    filt, dist = pf.scan_filter(pdfs, 1.1, 16.5, "js")
    assert torch.equal(filt[0], pdfs[0] / pdfs[0].sum())
    assert float(dist[0]) == 0.0
    f = pf.TemporalPDF(n=1.1, alpha=16.5, distance_metric="js")
    out, d = f.update_pdf(pdfs[0])
    assert d == 0.0 and torch.equal(out, filt[0])
    f.reset()
    assert f.previous_pdf is None


@pytest.mark.parametrize("metric", ("js", "l2"))
def test_batched_leading_dims_match_a_loop(metric):
    """(2, 3, T, n) sequences at once against each sequence alone."""
    pdfs = torch.from_numpy(_pdfs(4, (2, 3, T, 1232)))
    filt, dist = pf.scan_filter(pdfs, 1.1, 16.55, metric)
    assert filt.shape == pdfs.shape and dist.shape == (2, 3, T)
    for i in range(2):
        for j in range(3):
            f1, d1 = pf.scan_filter(pdfs[i, j], 1.1, 16.55, metric)
            torch.testing.assert_close(filt[i, j], f1, rtol=0, atol=ATOL)
            torch.testing.assert_close(dist[i, j], d1, rtol=0, atol=ATOL)


def test_unknown_metric_raises():
    with pytest.raises(ValueError, match="Unsupported"):
        pf.compute_distance(torch.ones(4), torch.ones(4), "cosine")


@pytest.mark.parametrize("dataset", [None, "speed", "speed_plus", "dspeed", "dspeed_video",
                                     "unknown"])
def test_filter_defaults_match_jax(dataset):
    assert pf.filter_defaults(dataset) == jpf.filter_defaults(dataset)
    assert pf.DOMAIN_FILTER_DEFAULTS == jpf.DOMAIN_FILTER_DEFAULTS
    assert pf.ORI_FILTER_DEFAULTS == jpf.ORI_FILTER_DEFAULTS
    assert pf.POS_FILTER_DEFAULTS == jpf.POS_FILTER_DEFAULTS
