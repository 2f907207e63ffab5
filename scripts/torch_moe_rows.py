"""Whether a token's row gets the same bits whatever the number of rows
beside it, for each product of the MoE layer at its full widths, on the
card.

A chunked prefill runs a prompt's tokens in 64-token products where the
whole prefill runs them in one product of a thousand rows or more; the two
give the same tokens only where every product computes a row the same way
at both row counts.  For M in 8..1,024 rows this compares each product's
first rows against the same rows of an 8,192-row (or E x 1,092-row) call:
the fp32 router product in one call and through ``models.moe.
router_logits`` (fixed blocks of ``ROUTER_ROWS``), the experts' gate and
down products as batched ``(E, t, .)`` products, the combine over the
experts, a single ``(t, E f) x (E f, d)`` product that would sum over the
experts as it contracts, and the dense bf16 products of the attention
(K 2,048) and of Qwen2-MoE's shared experts (K 5,632).  Prints one line a
product and writes ``chiprun_out/moe_rows.json`` with the card's name and
power limit.

Run on the card, from the repository root:
    python3 scripts/torch_moe_rows.py
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

ROWS = (8, 16, 32, 64, 128, 512, 1024)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_moe_rows: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi()
    g = torch.Generator(device="cuda")
    g.manual_seed(cs.SEED)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    out = {}

    def same(name, fn, full):
        """fn(m) -> the first m rows computed with m rows in the call."""
        out[name] = {m: bool(torch.equal(fn(m), full[:m])) for m in ROWS}
        cs.log(f"{name}: " + ", ".join(f"M {m} {'same' if v else 'differs'}"
                                       for m, v in out[name].items()))
    d = 2048
    for E, f in ((60, 1408), (64, 1024)):
        x = rnd(8192, d)
        router = rnd(d, E, dtype=torch.float32) * d ** -0.5
        xf = x.float()
        same(f"E {E}: router fp32, one product", lambda m: xf[:m] @ router,
             xf @ router)
        same(f"E {E}: router_logits", lambda m: moe.router_logits(router,
                                                                  x[:m]),
             moe.router_logits(router, x))
        T = 1092
        wg, wd = rnd(E, d, f), rnd(E, f, d)
        h = rnd(E, T, f)
        c = torch.rand((T, E), generator=g, device="cuda").to(torch.bfloat16)

        def gate(m):
            return torch.bmm(x[:m].unsqueeze(0).expand(E, m, d), wg)
        same(f"E {E}: gate (E, t, d) x (E, d, f)",
             lambda m: gate(m).transpose(0, 1), gate(T).transpose(0, 1))
        down = torch.bmm(h, wd)
        same(f"E {E}: down (E, t, f) x (E, f, d)",
             lambda m: torch.bmm(h[:, :m].contiguous(), wd).transpose(0, 1),
             down.transpose(0, 1))
        same(f"E {E}: combine etd,te->td",
             lambda m: torch.einsum("etd,te->td",
                                    down[:, :m].contiguous(), c[:m]),
             torch.einsum("etd,te->td", down, c))
        flat = h.transpose(0, 1).reshape(T, E * f)
        wflat = wd.reshape(E * f, d)
        same(f"E {E}: one product (t, E f) x (E f, d)",
             lambda m: flat[:m] @ wflat, flat @ wflat)
    for K in (2048, 5632):
        xs, w = rnd(8192, K), rnd(K, d)
        same(f"dense bf16 K {K}", lambda m: xs[:m] @ w, xs @ w)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "moe_rows.json"), "w") as fh:
        json.dump({"card": smi, "rows": ROWS, "same_bits": out}, fh,
                  indent=1)
    cs.log(f"OK MoE rows ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
