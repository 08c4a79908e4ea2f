"""A plain float32 forward of a served configuration, for the output check.

``Reference(config, seed, device).logits(seqs)`` takes each request as
(prompt, served tokens) and returns the logits at the positions that chose
the served tokens: row i of a request's logits is what the model predicts
for served token i, given the prompt and served tokens 0..i-1.  It runs
the whole sequence at once, and reproduces what the configuration states
about serving:

- the weights of the configuration's seed (``portbench.weights``), one
  layer drawn at a time, with the plan the ``serving`` section names
  worked out again from them: each projection's kept (bk, bn) blocks (the
  blocks whose mean |w| lies above the q_prune quantile of its slice), the
  int8 payload of a column over its kept rows and the column's scale, the
  token table's and the head's int8 columns;
- the prompt prefilled as one call: its rows attend to K and V as
  computed, and a MoE layer routes its tokens as one call (dispatch groups
  of the largest divisor of the prompt length up to the group target,
  ceil(G * top_k / experts * capacity_factor) slots an expert a group in
  (token, k) order past the full-capacity size, later assignments
  dropped);
- each served token decoded in a step of its own: its row attends to the
  int8 KV cache (K and V rounded per (token, head) to int8 and back) and
  its MoE call is under the full-capacity size, so nothing drops.

Everything is float32 with TF32 off.  ``precision="fp8"`` is the control:
the same forward with every activation that enters a product (a
projection's input, q, k, v, the attention probabilities, the head's
input, the router's input) rounded to float8 e4m3 with a scale a row.
``precision="bf16"`` rounds the same activations to bfloat16, the compute
type the configurations state (the weights are drawn in bfloat16
already): a look at how far that type alone moves the served tokens.
"""

from __future__ import annotations

import math

import torch

from portbench import weights as W

E4M3_MAX = 448.0
PLAN_DEFAULTS = {"min_size": 16384, "min_contract": 64}


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def e4m3(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 with one scale a row (the last axis)."""
    s = t.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


CASTS = {"fp32": _identity, "bf16": bf16, "fp8": e4m3}


# ---------------------------------------------------------------------------
# what the serving plan derives from the dense weights
# ---------------------------------------------------------------------------


def leaf_kind(name: str, shape: tuple, n_stack: int, serving: dict) -> str:
    """The representation the plan gives a leaf of per-layer ``shape``,
    stacked ``n_stack`` deep: the configured one where the leaf qualifies,
    else quant_sparse -> quant -> dense, block_sparse -> dense.  A leaf
    qualifies for int8 when it is a matrix of at least ``min_size``
    stacked elements whose contraction is at least ``min_contract`` long
    and whose name starts with "w" (or is the token table or the head);
    for the sparse kinds also when its name starts with "w" and its
    (K, N) tiles into (block, block) blocks."""
    leaf = name.rsplit("/", 1)[-1]
    want = serving.get("compress", "none")
    if want == "none" or len(shape) < 2:
        return "dense"
    K, N = shape[-2], shape[-1]
    min_size = serving.get("min_size", PLAN_DEFAULTS["min_size"])
    min_contract = serving.get("min_contract", PLAN_DEFAULTS["min_contract"])
    quant_ok = (n_stack * math.prod(shape) >= min_size and K >= min_contract
                and (leaf.startswith("w") or leaf in ("tok", "head")))
    b = serving["block"]
    sparse_ok = quant_ok and leaf.startswith("w") and K % b == 0 and N % b == 0
    if want in ("block_sparse", "quant_sparse") and not sparse_ok:
        want = "quant" if want == "quant_sparse" else "dense"
    if want == "quant" and not quant_ok:
        want = "dense"
    return want


def block_keep(w: torch.Tensor, q_prune: float, bk: int, bn: int) -> torch.Tensor:
    """(..., K/bk, N/bn) bool: the blocks of each (K, N) slice whose mean
    |w| (summed in float64, rounded to float32) lies above the
    round(q_prune * blocks)-th smallest of its slice."""
    *lead, K, N = w.shape
    nrb, ncb = K // bk, N // bn
    s = w.abs().reshape(*lead, nrb, bk, ncb, bn).to(torch.float64).mean(dim=(-3, -1))
    s = s.to(torch.float32)
    k = int(round(q_prune * nrb * ncb))
    if k == 0:
        return torch.ones_like(s, dtype=torch.bool)
    flat = s.reshape(*lead, nrb * ncb)
    delta = torch.sort(flat, dim=-1).values[..., k - 1]
    return s > delta[..., None, None]


def int8_columns(w: torch.Tensor) -> torch.Tensor:
    """w with each column (over the contraction axis -2) rounded to int8
    at the scale amax / 127, and back."""
    scale = w.abs().amax(dim=-2, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.round(w / scale).clamp(-127, 127) * scale


def served_weight(name: str, w: torch.Tensor, n_stack: int, serving: dict) -> torch.Tensor:
    """The float32 weight the configuration serves for dense ``w``."""
    w = w.to(torch.float32)
    kind = leaf_kind(name, tuple(w.shape), n_stack, serving)
    if kind == "dense":
        return w
    if kind == "quant":
        return int8_columns(w)
    b = serving["block"]
    keep = block_keep(w, serving.get("q_prune", 0.0), b, b)
    mask = keep.repeat_interleave(b, dim=-2).repeat_interleave(b, dim=-1)
    w = w * mask
    return int8_columns(w) * mask if kind == "quant_sparse" else w


def int8_rows(x: torch.Tensor) -> torch.Tensor:
    """x (..., hd) rounded to int8 per (token, head) at amax / 127, and
    back: what the int8 KV cache holds."""
    scale = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.round(x / scale).clamp(-127, 127) * scale


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------


def group_size(T: int, target: int) -> int:
    """The largest divisor of T that is at most ``target``."""
    g = min(T, target)
    while T % g:
        g -= 1
    return g


class Reference:
    """The configuration of ``config`` (a configuration file's dict) with
    the weights of ``seed``, on ``device``."""

    def __init__(self, config: dict, seed: int, device):
        self.port = config["port"]
        self.serving = config["serving"]
        self.sem = config["semantics"]
        self.seed = seed
        self.device = torch.device(device)
        self.hd = W.head_dim(self.port)
        tf32_off()

    # -- weights -------------------------------------------------------------

    def _global(self, name: str) -> torch.Tensor:
        w = W.draw_global(self.port, self.seed, name, self.device)
        return served_weight(name, w, 1, self.serving)

    def _layer_weights(self, i: int) -> dict:
        raw = W.draw_layer(self.port, self.seed, i, self.device)
        L = self.port["n_layers"]
        return {name: served_weight(name, t, L, self.serving) for name, t in raw.items()}

    # -- pieces ----------------------------------------------------------------

    def _norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        var = (x * x).mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.sem["rms_norm_eps"]) * (1.0 + scale)

    def _rope(self, x: torch.Tensor) -> torch.Tensor:
        """x (L, heads, hd) at positions 0..L-1, each head rotated in
        halves (not interleaved pairs)."""
        hd = x.shape[-1]
        base = self.port["rope_base"]
        freqs = base ** (-torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
        ang = torch.arange(x.shape[0], device=x.device, dtype=torch.float32)[:, None] * freqs
        sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _attend(self, q, k, v, q_pos, cast) -> torch.Tensor:
        """Causal attention of q (n, H, hd) at positions ``q_pos`` over k, v
        (m, KVH, hd) at 0..m-1; one KV head's group at a time."""
        n, H, hd = q.shape
        KVH = k.shape[1]
        G = H // KVH
        out = torch.empty_like(q)
        mask = torch.arange(k.shape[0], device=q.device)[None, :] <= q_pos[:, None]
        for g in range(KVH):
            qg = cast(q[:, g * G:(g + 1) * G]).permute(1, 0, 2)  # (G, n, hd)
            s = qg @ cast(k[:, g]).T / math.sqrt(hd)
            s = torch.where(mask, s, torch.tensor(float("-inf"), device=q.device))
            p = torch.softmax(s, dim=-1)
            out[:, g * G:(g + 1) * G] = (cast(p) @ cast(v[:, g])).permute(1, 0, 2)
        return out

    def _attention(self, w: dict, h: torch.Tensor, S: int, cast) -> torch.Tensor:
        L = h.shape[0]
        H, KVH, hd = self.port["n_heads"], self.port["n_kv_heads"], self.hd
        hc = cast(h)
        q = self._rope((hc @ w["attn/wq"]).view(L, H, hd))
        k = self._rope((hc @ w["attn/wk"]).view(L, KVH, hd))
        v = (hc @ w["attn/wv"]).view(L, KVH, hd)
        pos = torch.arange(L, device=h.device)
        o = torch.empty((L, H, hd), dtype=torch.float32, device=h.device)
        o[:S] = self._attend(q[:S], k[:S], v[:S], pos[:S], cast)
        if L > S:  # decode steps read the int8 cache, their own token's too
            o[S:] = self._attend(q[S:], int8_rows(k), int8_rows(v), pos[S:], cast)
        return cast(o.reshape(L, H * hd)) @ w["attn/wo"]

    def _ffn(self, wg, wu, wd, x: torch.Tensor, cast) -> torch.Tensor:
        return cast(torch.nn.functional.silu(x @ wg) * (x @ wu)) @ wd

    def _moe(self, w: dict, h: torch.Tensor, S: int, cast) -> torch.Tensor:
        m = self.port["moe"]
        E, K = m["n_experts"], m["top_k"]
        L = h.shape[0]
        hc = cast(h)
        probs = torch.softmax(hc @ w["moe/router"], dim=-1)
        gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, idx = gates[:, :K], idx[:, :K]
        if self.sem["moe_renormalize_topk"]:
            gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
        keep = torch.ones((L, K), dtype=torch.bool, device=h.device)
        if S > self.sem["moe_full_capacity_tokens"]:
            # the prompt's call: groups, and each expert's slots in (token, k) order
            G = group_size(S, self.sem["moe_group_target"])
            nG = S // G
            C = max(1, int(math.ceil(G * K / E * m["capacity_factor"])))
            oh = torch.nn.functional.one_hot(idx[:S].reshape(nG, G * K), E)
            before = oh.cumsum(dim=1) - oh
            slot = before.gather(2, idx[:S].reshape(nG, G * K, 1)).reshape(S, K)
            keep[:S] = slot < C
        out = torch.zeros((L, h.shape[1]), dtype=torch.float32, device=h.device)
        for e in range(E):
            rows, ks = torch.nonzero((idx == e) & keep, as_tuple=True)
            if rows.numel() == 0:
                continue
            y = self._ffn(w["moe/w_gate"][e], w["moe/w_up"][e], w["moe/w_down"][e], hc[rows], cast)
            out.index_add_(0, rows, gates[rows, ks][:, None] * y)
        if m.get("n_shared_experts"):
            out = out + self._ffn(w["moe/shared/w_gate"], w["moe/shared/w_up"],
                                  w["moe/shared/w_down"], hc, cast)
        return out

    def _layer(self, w: dict, x: torch.Tensor, S: int, cast) -> torch.Tensor:
        x = x + self._attention(w, self._norm(x, w["ln1/scale"]), S, cast)
        h = self._norm(x, w["ln2/scale"])
        if self.port.get("moe"):
            return x + self._moe(w, h, S, cast)
        return x + self._ffn(w["mlp/w_gate"], w["mlp/w_up"], w["mlp/w_down"], cast(h), cast)

    # -- the whole model -------------------------------------------------------

    @torch.no_grad()
    def logits(self, seqs: list, precisions=("fp32",)) -> dict:
        """{precision: [(n_i, V) float32 logits]} for ``seqs`` [(prompt,
        served)]: row j of request i predicts its served token j."""
        toks, starts = [], []
        for prompt, served in seqs:
            full = list(map(int, prompt)) + list(map(int, served))[:-1]
            toks.append(torch.tensor(full, dtype=torch.long, device=self.device))
            starts.append(len(prompt))
        table = self._global("embed/tok")
        xs = {p: [table[t] for t in toks] for p in precisions}
        del table
        for i in range(self.port["n_layers"]):
            w = self._layer_weights(i)
            for p in precisions:
                xs[p] = [self._layer(w, x, S, CASTS[p]) for x, S in zip(xs[p], starts)]
            del w
        final = W.draw_global(self.port, self.seed, "final_norm/scale", self.device)
        tied = self.port.get("tie_embeddings", True)
        head = self._global("embed/tok").T if tied else self._global("embed/head")
        out = {}
        for p in precisions:
            cast = CASTS[p]
            out[p] = [cast(self._norm(x[S - 1:], final)) @ head for x, S in zip(xs[p], starts)]
        return out
