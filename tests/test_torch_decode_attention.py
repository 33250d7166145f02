"""Kernel C (``csrc/decode_attention.cu``): which attention calls take it,
and, on the card, the kernel held to attention's plain code.

This file imports neither JAX nor the JAX package, so it also runs on a
machine with a GPU and no JAX:

    python -m pytest --noconftest tests/test_torch_decode_attention.py -q

The CPU cases check the path choice: a call runs the kernel only in bf16
on the card over a dense bf16 cache, at T <= 2, with no autograd and no
mesh; the CPU, float32, the int8 cache, grad, prefill and a mesh keep the
plain code. The ``cuda`` cases run the kernel against ``_attend_plain`` on
the card at the talker's and the predictor's shapes.
"""

from types import SimpleNamespace

import pytest
import torch

from qwen3_tts_tpu_torch.models import layers
from qwen3_tts_tpu_torch.models.layers import (
    KVQuant,
    WindowSplit,
    _attend_kernel,
    _attend_plain,
    _takes_decode_kernel,
    rope_slice,
    rope_tables,
)
from qwen3_tts_tpu_torch.ops import cuda_kernels

HD = 128
BF16 = torch.bfloat16


def _stand_in(T=1, heads=16, dtype=BF16, cuda=True, grad=False):
    """What the path choice reads of a projection: is_cuda, dtype,
    requires_grad, shape and device index."""
    return SimpleNamespace(is_cuda=cuda, dtype=dtype, requires_grad=grad,
                           shape=(4, T, heads * HD), get_device=lambda: 0)


def _cache(dtype=BF16):
    return SimpleNamespace(dtype=dtype, shape=(4, 64, 8, HD))


def _norm(grad=False):
    return SimpleNamespace(dtype=BF16, requires_grad=grad)


def _int8_cache():
    return KVQuant(torch.zeros((4, 64, 8, HD), dtype=torch.int8),
                   torch.zeros((4, 64, 8, 1)))


# (case, what differs from a bf16 talker decode call on the card over a
# 64-row cache, kernel?, counted as declined?)
ROUTES = [
    ("decode", {}, True, False),
    ("predictor_seed", {"T": 2, "heads": 8, "kv_heads": 8, "norms": 0}, True,
     False),
    ("row_positions", {"pos": torch.zeros(4, dtype=torch.int64)}, True, False),
    ("grad_off", {"grad": True, "no_grad": True}, True, False),
    ("window_split", {"split": ((2, 16), (2, 32)), "fits_up_to": 32}, True,
     False),
    ("cpu", {"cuda": False}, False, False),
    ("float32", {"dtype": torch.float32, "cache_dtype": torch.float32}, False,
     False),
    ("float32_cache", {"cache_dtype": torch.float32}, False, False),
    ("kv_int8", {"int8": True}, False, False),
    ("grad", {"grad": True}, False, False),
    ("norm_grad", {"norm_grad": True}, False, False),
    ("prefill", {"T": 3}, False, False),
    ("mesh", {"mesh": object()}, False, False),
    ("head_dim_64", {"head_dim": 64}, False, True),
    ("int32_positions", {"pos": torch.zeros(4, dtype=torch.int32)}, False,
     True),
    ("pos_past_cache", {"pos": 64}, False, True),
    ("window_too_wide", {"fits_up_to": 63}, False, True),
]


@pytest.mark.parametrize("case,change,kernel,declined", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_path_choice(case, change, kernel, declined, monkeypatch):
    """The path a call takes, the calls of the kernel's kind it declines,
    and the window its shared memory is sized for: the split's widest."""
    c = {"T": 1, "heads": 16, "kv_heads": 8, "norms": 2, "dtype": BF16,
         "cache_dtype": BF16, "cuda": True, "grad": False, "norm_grad": False,
         "int8": False, "mesh": None, "head_dim": HD, "pos": 5,
         "no_grad": False, "split": None, "fits_up_to": 64, **change}
    asked = []

    def fits(queries, window, device):  # the card's answer, made up here
        asked.append((queries, window, device))
        return window <= c["fits_up_to"]

    monkeypatch.setattr(layers, "fits", fits)
    q = _stand_in(c["T"], c["heads"], c["dtype"], c["cuda"], c["grad"])
    kv = _stand_in(c["T"], c["kv_heads"], c["dtype"], c["cuda"], c["grad"])
    cache = _int8_cache() if c["int8"] else _cache(c["cache_dtype"])
    norms = tuple(_norm(c["norm_grad"]) for _ in range(c["norms"]))
    before = cuda_kernels.DECODE_ATTENTION.declined
    with torch.no_grad() if c["no_grad"] else torch.enable_grad():
        got = _takes_decode_kernel(
            q, kv, kv, norms, cache, cache, c["pos"], 0, c["split"],
            c["heads"], c["kv_heads"], c["head_dim"], c["mesh"])
    assert got is kernel
    assert cuda_kernels.DECODE_ATTENTION.declined == before + declined
    window = 64 if c["split"] is None else max(w for _, w in c["split"])
    assert asked in ([], [(c["T"] * c["heads"] // c["kv_heads"], window, 0)])


def test_cpu_attention_keeps_the_plain_code():
    """A bf16 decode call on the CPU launches nothing, opens no kernel
    span and equals ``_attend_plain`` between its projections."""
    gen = torch.Generator().manual_seed(0)
    B, S, H, Hkv = 2, 16, 4, 2
    D = 64
    w = lambda n, k: {"w": (torch.randn(n, k, generator=gen) * 0.05).to(BF16)}
    p = {"q": w(H * HD, D), "k": w(Hkv * HD, D), "v": w(Hkv * HD, D),
         "o": w(D, H * HD), "q_norm": torch.ones(HD, dtype=BF16),
         "k_norm": torch.ones(HD, dtype=BF16)}
    x = torch.randn(B, 1, D, generator=gen).to(BF16)
    cos_t, sin_t = rope_tables(S, HD, 1e6)
    pos = torch.tensor([3, 7])
    cos, sin = rope_slice(cos_t, sin_t, pos, 1)
    ck = torch.randn(B, S, Hkv, HD, generator=gen).to(BF16)
    cv = torch.randn(B, S, Hkv, HD, generator=gen).to(BF16)
    args = dict(cos=cos, sin=sin, pos=pos, n_heads=H, n_kv_heads=Hkv,
                head_dim=HD, rms_eps=1e-6, qk_norm=True, pad_len=0,
                window_split=WindowSplit(((1, 8), (1, 16))))
    before = cuda_kernels.DECODE_ATTENTION.launches
    ck1, cv1 = ck.clone(), cv.clone()
    with torch.autograd.profiler.profile(use_kineto=True) as prof:
        out = layers.attention(p, x, cache_k=ck1, cache_v=cv1, **args).out
    assert cuda_kernels.DECODE_ATTENTION.launches == before
    names = {e.name() for e in prof.kineto_results.events()}
    assert "qwen3_tts.model.attention" in names
    assert "qwen3_tts.kernel.decode_attention" not in names
    ck2, cv2 = ck.clone(), cv.clone()
    q, k, v = (layers.linear(x, p[n]) for n in "qkv")
    ctx = _attend_plain(p, q, k, v, cache_k=ck2, cache_v=cv2,
                        out_dtype=BF16, **args)
    assert torch.equal(out, layers.linear(ctx, p["o"]))
    assert torch.equal(ck1, ck2) and torch.equal(cv1, cv2)


def test_window_split_table_is_made_once():
    split = WindowSplit(((2, 8), (3, 16)))
    assert split == ((2, 8), (3, 16))
    t = split.table(5, torch.device("cpu"))
    assert t.tolist() == [8, 8, 16, 16, 16] and t.dtype == torch.int64
    assert split.table(5, torch.device("cpu")) is t
    with pytest.raises(ValueError, match="covers 5 of 6 rows"):
        WindowSplit(((2, 8), (3, 16))).table(6, torch.device("cpu"))


# ------------------------------------------------------------------ the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    return torch.device("cuda")


# (query heads, kv heads, qk_norm): the talker's and the predictor's
SHAPES = {"talker": (16, 8, True), "predictor": (8, 8, False)}
B, S = 8, 96          # rows; cache positions (a view of a longer cache)
# per-row (pos, pad): decoding rows, one at the cache's end, a padded
# query (pos < pad), a stale slot past its group's window (row 3, window
# 40 under the split) and one past the cache itself (clamped write)
ROW_POS = [5, 30, S - 2, 60, 3, 41, 77, S + 9]
ROW_PAD = [0, 4, 0, 2, 6, 0, 11, 0]
WINDOWS = ((4, 40), (4, S))


def _card_case(dev, seed, shape, T, per_row, split, fused):
    H, Hkv, qk_norm = SHAPES[shape]
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)
    if fused:  # views of one [B, T, (H + 2 Hkv) * hd] product
        qkv = rnd(B, T, (H + 2 * Hkv) * HD).to(BF16)
        q = qkv[..., :H * HD]
        k = qkv[..., H * HD:(H + Hkv) * HD]
        v = qkv[..., (H + Hkv) * HD:]
    else:
        q = rnd(B, T, H * HD).to(BF16)
        k = (rnd(B, T, Hkv * HD) * 2).to(BF16)
        v = rnd(B, T, Hkv * HD).to(BF16)
    p = {"q_norm": (1 + 0.2 * rnd(HD)).to(BF16),
         "k_norm": (1 + 0.2 * rnd(HD)).to(BF16)}
    # the caches as the engine holds them: views of a longer cache
    full = [rnd(B, S + 16, Hkv, HD).to(BF16) for _ in range(2)]
    cos_t, sin_t = rope_tables(S + 16, HD, 1e6, dev)
    if per_row:
        pos = torch.tensor(ROW_POS, dtype=torch.int64, device=dev)
        pad = torch.tensor(ROW_PAD, dtype=torch.int64, device=dev)
    else:
        pos, pad = 37, 3
    cos, sin = rope_slice(cos_t, sin_t, pos, T)
    args = dict(cos=cos, sin=sin, pos=pos, n_heads=H, n_kv_heads=Hkv,
                head_dim=HD, rms_eps=1e-6, qk_norm=qk_norm, pad_len=pad,
                window_split=WindowSplit(WINDOWS) if split else None,
                out_dtype=BF16)
    return p, q, k, v, full, args


def _written(per_row, T):
    """[B, S] mask of the cache rows a call writes."""
    m = torch.zeros(B, S, dtype=torch.bool)
    for b in range(B):
        start = min(max(ROW_POS[b] if per_row else 37, 0), S - T)
        m[b, start:start + T] = True
    return m


def _within_one_ulp(a, b):
    a, b = a.float(), b.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    return bool(((a - b).abs() <= torch.ldexp(torch.ones_like(a), e - 8))
                .all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("per_row,split", [(False, False), (True, False),
                                           (True, True)],
                         ids=["int_pos", "row_pos", "row_pos_two_windows"])
def test_kernel_matches_plain_on_cuda(cuda_device, shape, T, per_row, split):
    p, q, k, v, full, args = _card_case(cuda_device, 1, shape, T, per_row,
                                        split, fused=shape == "talker")
    view = lambda: [c.clone()[:, :S] for c in full]
    cache = [c[:, :S] for c in full]
    norms = (p["q_norm"], p["k_norm"]) if args["qk_norm"] else ()
    assert _takes_decode_kernel(q, k, v, norms, *cache, args["pos"],
                                args["pad_len"], args["window_split"],
                                args["n_heads"], args["n_kv_heads"], HD, None)
    plain = view()
    want = _attend_plain(p, q, k, v, cache_k=plain[0], cache_v=plain[1],
                         **args)
    before = cuda_kernels.DECODE_ATTENTION.launches
    outs, caches = [], []
    for _ in range(2):  # two launches on the same inputs
        kc = view()
        outs.append(_attend_kernel(p, q, k, v, cache_k=kc[0], cache_v=kc[1],
                                   **args))
        caches.append(kc)
    torch.cuda.synchronize()
    assert cuda_kernels.DECODE_ATTENTION.launches == before + 2
    got = outs[0]
    # repeats are bit-identical
    assert torch.equal(outs[0], outs[1])
    assert all(torch.equal(a, b) for a, b in zip(*caches))
    # written rows within one bf16 ulp (the norm's f32 sum in another
    # order), every other row untouched
    written = _written(per_row, T)
    for kc, pc, old in zip(caches[0], plain, cache):
        kc, pc, old = kc.cpu(), pc.cpu(), old.cpu()
        assert torch.equal(kc[~written], old[~written])
        assert _within_one_ulp(kc[written], pc[written])
    # the context: bf16 rounding of f32 sums taken in another order
    assert got.shape == want.shape and got.dtype == BF16
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item(), err


@pytest.mark.cuda
def test_fits_reads_the_kernels_shared_memory_on_cuda(cuda_device):
    """Two score rows over 16k keys fit an H100 block's shared memory, over
    32k they do not; nine query rows never fit (the kernel holds eight)."""
    dev = cuda_device.index or 0
    assert layers.fits(2, 16384, dev) and not layers.fits(2, 32768, dev)
    assert layers.fits(8, 2048, dev) and not layers.fits(9, 1, dev)


@pytest.mark.cuda
def test_kernel_runs_under_attention_at_serving_shapes_on_cuda(cuda_device):
    """``layers.attention`` on the card: the talker's decode call at 64
    rows over a 1024-row window of a 3072-row cache takes the kernel,
    opens its span once and equals the plain code's output."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    rows, S_max, A, D = 64, 3072, 1024, 2048
    w = lambda n, k: {"w": (torch.randn(n, k, generator=gen, device=cuda_device)
                            * 0.02).to(BF16)}
    p = {"q": w(16 * HD, D), "k": w(8 * HD, D), "v": w(8 * HD, D),
         "o": w(D, 16 * HD), "q_norm": torch.ones(HD, dtype=BF16,
                                                  device=cuda_device),
         "k_norm": torch.ones(HD, dtype=BF16, device=cuda_device)}
    x = torch.randn(rows, 1, D, generator=gen, device=cuda_device).to(BF16)
    full = [torch.randn(rows, S_max, 8, HD, generator=gen,
                        device=cuda_device).to(BF16) for _ in range(2)]
    pos = torch.randint(0, A - 1, (rows,), generator=gen, device=cuda_device)
    cos_t, sin_t = rope_tables(S_max, HD, 1e6, cuda_device)
    cos, sin = rope_slice(cos_t, sin_t, pos, 1)
    args = dict(cos=cos, sin=sin, pos=pos, n_heads=16, n_kv_heads=8,
                head_dim=HD, rms_eps=1e-6, qk_norm=True,
                pad_len=torch.zeros(rows, dtype=torch.int64,
                                    device=cuda_device),
                window_split=WindowSplit(((32, 512), (32, A))))
    kc = [c.clone()[:, :A] for c in full]
    before = cuda_kernels.DECODE_ATTENTION.launches
    with torch.no_grad(), torch.autograd.profiler.profile(
            use_kineto=True) as prof:
        got = layers.attention(p, x, cache_k=kc[0], cache_v=kc[1],
                               **args).out
    torch.cuda.synchronize()
    assert cuda_kernels.DECODE_ATTENTION.launches == before + 1
    spans = [e for e in prof.kineto_results.events()
             if e.name() == "qwen3_tts.kernel.decode_attention"]
    assert len(spans) == 1
    pc = [c.clone()[:, :A] for c in full]
    q, k, v = (layers.linear(x, p[n]) for n in "qkv")
    ctx = _attend_plain(p, q, k, v, cache_k=pc[0], cache_v=pc[1],
                        out_dtype=BF16, **args)
    want = layers.linear(ctx, p["o"])
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-2 * want.float().abs().max().item(), err
