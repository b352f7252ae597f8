"""petsc_tpu_torch's gather kernels K5-K8 on the CPU: each plain version
(which the wrapper runs for a CPU tensor) against the reference expression
of its Pallas probe, evaluated with jnp on the CPU, on the probes' own
inputs cut to a small size; and the wrappers' input checks. The probes'
Pallas bodies use the TPU-only VMEM memory space and have no interpret-mode
test in the JAX package, so their reference expressions are the plain
reference. A gather is exact: every comparison is for equality.

The CUDA kernels themselves are tested on a card by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petsc_tpu_torch.ops import gather_kernels as gk

torch.set_num_threads(1)

C, B, N, M = 1024, 64, 4096, 16384     # probe_s1/s2/s3 rows and x2 rows; probe_g1 n, m
DTYPES = (np.float64, np.float32)


def _probe_values(count, period, dt):
    """The probes' x: 0.5 + (i % period) / period, in jnp then as numpy."""
    return np.array((0.5 + (jnp.arange(count) % period) / period).astype(dt))


def _equal(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dt", DTYPES)
def test_lane_shuffle_equals_probe_s1_reference(dt):
    rng = np.random.default_rng(0)
    V = _probe_values(C * 128, 997, dt).reshape(C, 128)
    s = rng.integers(0, 128, (C, 128), dtype=np.int32)
    want = jnp.take_along_axis(jnp.asarray(V), jnp.asarray(s), axis=1)
    _equal(gk.lane_shuffle_plain(torch.from_numpy(V), torch.from_numpy(s)), want)
    _equal(gk.lane_shuffle(torch.from_numpy(V), torch.from_numpy(s)), want)


@pytest.mark.parametrize("dt", DTYPES)
def test_row_gather_equals_probe_s2_reference(dt):
    rng = np.random.default_rng(1)
    x2 = _probe_values(B * 128, 997, dt).reshape(B, 128)
    q = rng.integers(0, B, (C,), dtype=np.int32)
    want = jnp.take(jnp.asarray(x2), jnp.asarray(q), axis=0)
    _equal(gk.row_gather_plain(torch.from_numpy(x2), torch.from_numpy(q)), want)
    _equal(gk.row_gather(torch.from_numpy(x2), torch.from_numpy(q)), want)


@pytest.mark.parametrize("dt", DTYPES)
def test_gather2_equals_probe_s3_reference(dt):
    rng = np.random.default_rng(2)
    x2 = _probe_values(B * 128, 997, dt).reshape(B, 128)
    q = rng.integers(0, B, (C, 128), dtype=np.int32)
    s = rng.integers(0, 128, (C, 128), dtype=np.int32)
    want = jnp.asarray(x2).reshape(-1)[jnp.asarray(q) * 128 + jnp.asarray(s)]
    args = (torch.from_numpy(x2), torch.from_numpy(q), torch.from_numpy(s))
    _equal(gk.gather2_plain(*args), want)
    _equal(gk.gather2(*args), want)


@pytest.mark.parametrize("dt", DTYPES)
def test_gather_equals_probe_g1_reference(dt):
    rng = np.random.default_rng(0)
    x = _probe_values(N, 1000, dt)
    idx = rng.integers(0, N, M, dtype=np.int32)
    want = jnp.asarray(x)[jnp.asarray(idx)].reshape(-1, 128)
    idx2 = torch.from_numpy(idx).reshape(-1, 128)
    _equal(gk.gather_plain(torch.from_numpy(x), idx2), want)
    _equal(gk.gather(torch.from_numpy(x), idx2), want)


def test_cpu_tensors_count_no_launch():
    gk.reset_launches()
    x = torch.arange(256, dtype=torch.float64)
    i = torch.arange(128, dtype=torch.int32)
    gk.gather(x, i)
    gk.gather2(x.view(2, 128), i.view(1, -1) % 2, i.view(1, -1))
    gk.row_gather(x.view(2, 128), i % 2)
    gk.lane_shuffle(x.view(2, 128), torch.stack([i, i]))
    assert gk.LAUNCHES == {"lane_shuffle": 0, "row_gather": 0, "gather2": 0, "gather": 0}


def _bad_calls():
    x = torch.ones(256, dtype=torch.float64)
    x2 = x.view(2, 128)
    i = torch.zeros(128, dtype=torch.int32)
    s = torch.zeros((2, 128), dtype=torch.int32)
    return {
        "gather_int64_index": (TypeError, lambda: gk.gather(x, i.long())),
        "gather_half": (TypeError, lambda: gk.gather(x.half(), i)),
        "gather_int_values": (TypeError, lambda: gk.gather(x.long(), i)),
        "gather_2d_values": (ValueError, lambda: gk.gather(x2, i)),
        "gather_strided_values": (ValueError, lambda: gk.gather(x[::2], i)),
        "gather_strided_index": (ValueError, lambda: gk.gather(x, s[:, ::2])),
        "gather_high": (IndexError, lambda: gk.gather(x, i + 256)),
        "gather_negative": (IndexError, lambda: gk.gather(x, i - 1)),
        "gather2_shapes": (ValueError, lambda: gk.gather2(x2, s, i)),
        "gather2_row_high": (IndexError, lambda: gk.gather2(x2, s + 2, s)),
        "gather2_lane_high": (IndexError, lambda: gk.gather2(x2, s, s + 128)),
        "row_gather_2d_index": (ValueError, lambda: gk.row_gather(x2, s)),
        "row_gather_high": (IndexError, lambda: gk.row_gather(x2, i + 2)),
        "lane_shuffle_width": (ValueError, lambda: gk.lane_shuffle(x.view(4, 64), s.view(4, 64))),
        "lane_shuffle_shapes": (ValueError, lambda: gk.lane_shuffle(x2, s[:1])),
        "lane_shuffle_high": (IndexError, lambda: gk.lane_shuffle(x2, s + 128)),
        # the plain versions raise on an index out of range, and so does an
        # unchecked wrapper on the CPU, which runs its plain version
        "lane_shuffle_plain_high": (RuntimeError, lambda: gk.lane_shuffle_plain(x2, s + 128)),
        "lane_shuffle_unchecked_high": (RuntimeError,
                                        lambda: gk.lane_shuffle(x2, s + 128, check=False)),
        "gather_plain_high": (IndexError, lambda: gk.gather_plain(x, i + 256)),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    exc, call = _bad_calls()[case]
    with pytest.raises(exc):
        call()
