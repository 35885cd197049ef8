"""The port's flash attention against the reference's Pallas kernel.

On the CPU ``ops.flash_attention`` runs its plain version (``ref.py``); it
is held against the JAX wrapper with ``use_pallas=True, interpret=True``,
as the reference's tests/test_flash_attn.py runs it, on inputs made with
numpy.  The reference takes KV already expanded to H heads; the port
takes (B, S, KV, hd) and maps head h to KV head h // (H // KV), so the
JAX side gets ``np.repeat(k, H // KV, axis=2)``, the head order of
``expand_kv``.  Tolerances are the reference's own (tests/test_flash_attn.py):
2e-5 in fp32 (summation order) and 2e-2 in bf16 (p is rounded to bf16
before p . v, at other points than the reference's exact-softmax oracle).

The cases with ``S = (Sq, Sk)`` give the keys a length of their own.

``tensor_map_layout`` (the TMA tensor maps' dims and byte strides, computed
in the wrapper) is checked on the CPU, with the layouts it must copy.

The ``*_on_card`` tests hold the CUDA kernel against its plain version and
skip where no card is present.  The two round p the same way, so only
summation order and the output's rounding (one ulp, 2^-8 relative in
bf16) separate them: the bound is |got - want| <= 4e-3 + 1e-2 |want|, and
a relative L2 error of at most 1e-2 where long rows make outputs small.  The module imports no JAX itself, so they
also run where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_flash_attn.py -k on_card
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.core.convert import leaves_from_numpy
from repro_torch.kernels.flash_attn import ops as tops
from repro_torch.kernels.flash_attn import ref as tref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
CARD_ATOL, CARD_RTOL, CARD_REL_L2 = 4e-3, 1e-2, 1e-2


@pytest.fixture(scope="module")
def jflash():
    """The reference's flash wrapper (the Pallas kernel in interpret mode)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.flash_attn import ops
    return types.SimpleNamespace(jnp=jnp, ops=ops)


@pytest.fixture()
def cuda_device():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _card_close(got, want):
    """The kernel's output against its plain version's (see the module's
    docstring for the bounds)."""
    g, w = _f32(got), _f32(want)
    np.testing.assert_allclose(g, w, rtol=CARD_RTOL, atol=CARD_ATOL)
    assert np.linalg.norm(g - w) <= CARD_REL_L2 * np.linalg.norm(w)


def _inputs(seed, B, S, H, KV, hd, dtype):
    """q (B, Sq, H, hd), k and v (B, Sk, KV, hd) as numpy arrays of
    ``dtype`` (bf16 through ml_dtypes); ``S`` is Sq = Sk, or (Sq, Sk)."""
    Sq, Sk = S if isinstance(S, tuple) else (S, S)
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, hd), dtype=np.float32)
    k = rng.standard_normal((B, Sk, KV, hd), dtype=np.float32)
    v = rng.standard_normal((B, Sk, KV, hd), dtype=np.float32)
    if dtype == "bfloat16":
        import ml_dtypes
        q, k, v = (x.astype(ml_dtypes.bfloat16) for x in (q, k, v))
    return q, k, v


def _torch(arrays, device="cpu"):
    return [leaves_from_numpy({"x": a}, device)["x"] for a in arrays]


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("B,S,H,KV,hd,causal,dtype", [
    (1, 16, 4, 2, 16, True, "float32"),
    (2, 64, 4, 1, 32, True, "float32"),
    (1, 128, 6, 2, 64, False, "float32"),
    (2, 256, 4, 4, 128, True, "float32"),
    (1, 96, 6, 3, 64, True, "float32"),
    (1, 256, 8, 2, 64, True, "bfloat16"),
    (2, 96, 3, 1, 128, False, "bfloat16"),
    (2, 128, 4, 2, 128, True, "bfloat16"),
    # (Sq, Sk): a key length of its own (cross attention over an encoder
    # memory); the Pallas kernel takes Sk % min(256, Sk) == 0.
    (2, (64, 256), 4, 2, 64, True, "float32"),
    (2, (64, 256), 4, 2, 64, False, "float32"),
    (1, (256, 96), 6, 3, 32, True, "float32"),
    (1, (256, 96), 6, 3, 32, False, "float32"),
    (1, (96, 512), 4, 4, 128, False, "bfloat16"),
    (2, (256, 64), 4, 1, 64, True, "bfloat16"),
])
def test_plain_vs_pallas(jflash, B, S, H, KV, hd, causal, dtype):
    q, k, v = _inputs(B * q_len(S) + H, B, S, H, KV, hd, dtype)
    G = H // KV
    want = jflash.ops.flash_attention(
        jflash.jnp.asarray(q), jflash.jnp.asarray(np.repeat(k, G, axis=2)),
        jflash.jnp.asarray(np.repeat(v, G, axis=2)), causal=causal,
        use_pallas=True, interpret=True)
    tq, tk, tv = _torch((q, k, v))
    got = tops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and tuple(got.shape) == (B, q_len(S), H, hd)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype], atol=TOL[dtype])


def q_len(S) -> int:
    return S[0] if isinstance(S, tuple) else S


def test_plain_keys_past_sk_and_the_absolute_causal_mask():
    """Sq > Sk: rows past Sk see every key; causal rows r < Sk see keys
    c <= r, as in the TPU kernel's absolute-index mask."""
    tq, tk, tv = _torch(_inputs(5, 1, (48, 20), 2, 1, 32, "float32"))
    causal = tref.attention(tq, tk, tv, causal=True)
    full = tref.attention(tq, tk, tv, causal=False)
    assert torch.equal(causal[:, 20:], full[:, 20:])
    assert not torch.equal(causal[:, :19], full[:, :19])
    one = tref.attention(tq[:, :1], tk[:, :1], tv[:, :1], causal=False)
    np.testing.assert_allclose(causal[:, :1].numpy(), one.numpy(), rtol=1e-6, atol=1e-6)


def test_cpu_wrapper_is_the_plain_version():
    tq, tk, tv = _torch(_inputs(3, 2, 33, 4, 2, 64, "bfloat16"))
    before = tops.LAUNCHES
    got = tops.flash_attention(tq, tk, tv, causal=True)
    assert torch.equal(got, tref.attention(tq, tk, tv, causal=True))
    assert tops.LAUNCHES == before, "a CPU tensor must not count a launch"


def test_plain_causal_rows_ignore_later_keys():
    """Row r of a causal attention depends on keys <= r only."""
    tq, tk, tv = _torch(_inputs(4, 1, 40, 2, 1, 32, "float32"))
    full = tref.attention(tq, tk, tv, causal=True)
    tk2, tv2 = tk.clone(), tv.clone()
    tk2[:, 20:] = 7.0
    tv2[:, 20:] = -3.0
    cut = tref.attention(tq, tk2, tv2, causal=True)
    assert torch.equal(full[:, :20], cut[:, :20])
    assert not torch.equal(full[:, 20:], cut[:, 20:])


@pytest.mark.parametrize("shapes", [
    ((1, 8, 4, 16), (1, 8, 3, 16), (1, 8, 3, 16)),     # H % KV != 0
    ((1, 8, 4, 16), (2, 9, 2, 16), (2, 9, 2, 16)),     # B differs
    ((1, 8, 4, 16), (1, 8, 2, 16), (1, 8, 2, 32)),     # k, v differ
    ((8, 4, 16), (8, 2, 16), (8, 2, 16)),              # not 4-d
    ((1, 8, 4, 16), (1, 9, 2, 16), (1, 8, 2, 16)),     # k, v differ in length
    ((1, 8, 4, 16), (1, 0, 2, 16), (1, 0, 2, 16)),     # Sk < 1
    ((1, 0, 4, 16), (1, 8, 2, 16), (1, 8, 2, 16)),     # Sq < 1
])
def test_wrapper_rejects_bad_shapes(shapes):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        tops.flash_attention(q, k, v)


# ------------------------------------------------ the tensor maps' layout
def test_tensor_map_layout_contiguous():
    x = torch.zeros((2, 5, 3, 64), dtype=torch.bfloat16)
    assert tops.tensor_map_layout(x) == ((64, 3, 5, 2), (128, 384, 1920))
    assert tops._strided(x) is x


@pytest.mark.parametrize("dtype,es", [(torch.bfloat16, 2), (torch.float32, 4)])
def test_tensor_map_layout_fused_qkv_slices(dtype, es):
    """q, k and v sliced out of one (B, S, H + 2 KV, hd) tensor are read in
    place: head stride hd, sequence stride (H + 2 KV) hd, 16-byte bases."""
    B, S, H, KV, hd = 2, 7, 6, 2, 128
    qkv = torch.zeros((B, S, H + 2 * KV, hd), dtype=dtype)
    row = (H + 2 * KV) * hd * es
    for x, heads in ((qkv[:, :, :H], H), (qkv[:, :, H:H + KV], KV),
                     (qkv[:, :, H + KV:], KV)):
        assert tops.tensor_map_layout(x) == ((hd, heads, S, B), (hd * es, row, S * row))
        assert tops._strided(x) is x


def test_tensor_map_layout_size_one_dims_take_the_enclosing_extent():
    """A dim of size 1 is never stepped: whatever stride torch reports for
    it, the map gets the extent of the dims inside it."""
    base = torch.zeros(4096, dtype=torch.bfloat16)
    x = base.as_strided((1, 3, 1, 64), (5, 64, 7, 1))
    assert tops.tensor_map_layout(x) == ((64, 1, 3, 1), (128, 128, 384))


@pytest.mark.parametrize("case", ["unaligned base", "stride not 16 bytes",
                                  "hd not unit stride", "heads outside seq"])
def test_tensor_map_layout_rejects_and_copies(case):
    """Layouts a tensor map cannot describe give None, and the wrapper's
    copy of them is packed and equal."""
    base = torch.arange(2 * 9 * 4 * 64 * 2, dtype=torch.float32).to(torch.bfloat16)
    if case == "unaligned base":
        x = base[1:1 + 2 * 9 * 4 * 64].view(2, 9, 4, 64)
    elif case == "stride not 16 bytes":
        x = base.as_strided((2, 9, 4, 64), (9 * 4 * 68, 4 * 68, 68, 1))
    elif case == "hd not unit stride":
        x = base[:2 * 9 * 4 * 64].view(2, 9, 64, 4).transpose(2, 3)
    else:                                    # a (B, heads, S, hd) tensor's view
        x = base[:2 * 9 * 4 * 64].view(2, 4, 9, 64).transpose(1, 2)
    assert tops.tensor_map_layout(x) is None
    y = tops._strided(x)
    assert y.data_ptr() != x.data_ptr() and torch.equal(y, x)
    assert tops.tensor_map_layout(y) == ((64, 4, 9, 2), (128, 512, 4608))


# ------------------------------------------------------------ on the card
@pytest.mark.parametrize("S", [1, 17, 255, 1000])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("group", [1, 3, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_on_card(cuda_device, S, hd, group, causal):
    KV = 2
    q, k, v = _torch(_inputs(S + hd + group, 2, S, KV * group, KV, hd, "bfloat16"),
                     cuda_device)
    before = tops.LAUNCHES
    got = tops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tops.LAUNCHES == before + 1
    want = tref.attention(q, k, v, causal=causal)
    _card_close(got, want)


@pytest.mark.parametrize("Sq,Sk", [(1, 17), (129, 1000), (1000, 129), (200, 383),
                                   (383, 128)])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_cross_lengths_on_card(cuda_device, Sq, Sk, hd, causal):
    """A key length other than the query's, ragged on both sides of the
    128-row tiles (cross attention over an encoder memory), 8 query heads
    in 4 / 2 groups."""
    q, k, v = _torch(_inputs(Sq + Sk + hd, 2, (Sq, Sk), 8, 2, hd, "bfloat16"),
                     cuda_device)
    before = tops.LAUNCHES
    got = tops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tops.LAUNCHES == before + 1 and tuple(got.shape) == (2, Sq, 8, hd)
    _card_close(got, tref.attention(q, k, v, causal=causal))


def test_flash_kernel_fp16_and_strided_on_card(cuda_device):
    """fp16, and q, k, v read by strides out of one fused qkv tensor."""
    B, S, H, KV, hd = 2, 300, 8, 2, 128
    g = torch.Generator(device=cuda_device).manual_seed(0)
    qkv = torch.randn((B, S, H + 2 * KV, hd), generator=g, device=cuda_device,
                      dtype=torch.float16)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    got = tops.flash_attention(q, k, v, causal=True)
    want = tref.attention(q, k, v, causal=True)
    _card_close(got, want)


def test_flash_kernel_rejects_fp32_on_card(cuda_device):
    q = torch.zeros((1, 8, 2, 64), device=cuda_device)
    with pytest.raises(ValueError, match="bf16 or fp16"):
        tops.flash_attention(q, q, q)


@pytest.mark.parametrize("S", [127, 128, 129, 383, 4096])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_tile_boundaries_on_card(cuda_device, S, hd, causal):
    """Lengths around the kernel's 128-query and 128-key tiles, and a whole
    prefill-length sequence (the ragged tail and the diagonal tile)."""
    q, k, v = _torch(_inputs(S + hd, 1, S, 6, 2, hd, "bfloat16"), cuda_device)
    got = tops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    _card_close(got, tref.attention(q, k, v, causal=causal))


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_sixteen_query_heads_a_kv_head_on_card(cuda_device, hd, causal):
    """16 query heads a KV head, qwen3-moe's grouping (64 / 4 heads), over
    the ragged tail of a 128-row tile."""
    q, k, v = _torch(_inputs(16 + hd, 2, 300, 64, 4, hd, "bfloat16"), cuda_device)
    got = tops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    _card_close(got, tref.attention(q, k, v, causal=causal))


def test_flash_kernel_many_heads_on_card(cuda_device):
    """B * H = 192 query heads in 24 / 8 groups, the prefill's: the block
    order over (b, KV head), query tiles and a group's heads."""
    q, k, v = _torch(_inputs(7, 8, 384, 24, 8, 128, "bfloat16"), cuda_device)
    got = tops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    _card_close(got, tref.attention(q, k, v, causal=True))


@pytest.mark.parametrize("S", [129, 383])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_flash_kernel_fused_qkv_slices_on_card(cuda_device, S, hd, dtype):
    """q, k, v sliced out of one (B, S, H + 2 KV, hd) tensor: read in place
    (no copy), with head and sequence strides unlike a contiguous tensor's."""
    B, H, KV = 2, 6, 2
    g = torch.Generator(device=cuda_device).manual_seed(S + hd)
    qkv = torch.randn((B, S, H + 2 * KV, hd), generator=g, device=cuda_device,
                      dtype=dtype)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    assert all(tops._strided(x) is x for x in (q, k, v))
    for causal in (True, False):
        got = tops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        _card_close(got, tref.attention(q, k, v, causal=causal))


@pytest.mark.parametrize("scale", [0.05, 0.0, -0.125])
def test_flash_kernel_explicit_scale_on_card(cuda_device, scale):
    """A caller's scale: zero (uniform weights over the unmasked keys) and
    a negative one too (the wrapper hands the kernel -q and -scale: the
    same scores, exactly)."""
    q, k, v = _torch(_inputs(11, 2, 200, 4, 2, 128, "bfloat16"), cuda_device)
    got = tops.flash_attention(q, k, v, causal=True, scale=scale)
    torch.cuda.synchronize()
    _card_close(got, tref.attention(q, k, v, causal=True, scale=scale))
