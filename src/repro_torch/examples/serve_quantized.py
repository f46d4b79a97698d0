"""Batched serving with SYMOG fixed-point weights: the deployment story (the
counterpart of ``examples/serve_quantized.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_quantized [--arch internlm2-1.8b] \\
        [--device cpu]

1. Builds a reduced LM and SYMOG-fine-tunes it briefly (so the weights sit
   ON the fixed-point grid: post-quantization is then exact by training);
   on the card the update is one norm pass and one ``symog_update`` per
   quantizable leaf a step.
2. Serves a batch of prompts with float weights vs hard-quantized weights
   and reports the generated-token agreement (paper claim: ≈ lossless).
3. Packs the WHOLE model (``pack_tree`` → 2-bit mantissas, 4 per int8
   byte) and serves the packed artifact through the same ``ServeEngine``:
   on the card the ``fixedpoint_matmul`` and ``paged_attention`` kernels,
   on the CPU their exact plain versions.  Generation must be
   token-identical to the hard-quantized float weights; the report shows
   the resident-byte win.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs, core, optim
from repro_torch.data import SyntheticLM, SyntheticLMConfig
from repro_torch.device import resolve_device
from repro_torch.models import forward_lm, init_lm
from repro_torch.serve import ServeEngine
from repro_torch.train import init_train_state, make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b", choices=configs.ARCHS)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default: the card (required)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = configs.get_reduced(args.arch)
    data = SyntheticLM(SyntheticLMConfig(
        vocab_size=cfg.vocab_size, seq_len=64, global_batch=8, noise=0.05))
    params = init_lm(0, cfg, device=dev)

    # brief SYMOG QAT so the weights converge onto the fixed-point modes
    tx = optim.chain(optim.clip_by_global_norm(1.0), optim.sgd(momentum=0.9))
    scfg = core.SymogConfig(n_bits=2, total_steps=args.steps)  # λ0=10 (paper)
    step = make_train_step(cfg, tx, core.constant(0.05), symog_cfg=scfg,
                           compute_dtype=torch.float32)
    state = init_train_state(params, tx, scfg)
    for _ in range(args.steps):
        state, m = step(state, next(data))
    qm = core.quant_error_metrics(state.params, state.symog, scfg)
    print(f"QAT done: loss {float(m['loss']):.3f}, "
          f"rel quant error {float(qm['rel_quant_error']):.2e}")

    # teacher-forced next-token agreement (the paper's accuracy-style claim)
    test = {"tokens": torch.as_tensor(data.peek(9999)["tokens"], device=dev)}
    qparams = core.quantize_tree(state.params, state.symog, scfg)
    with torch.no_grad():
        lf = forward_lm(state.params, test, cfg, compute_dtype=torch.float32).logits
        lq = forward_lm(qparams, test, cfg, compute_dtype=torch.float32).logits
    tf_agree = float(torch.mean((lf.argmax(-1) == lq.argmax(-1)).to(torch.float32)))
    print(f"teacher-forced next-token agreement (2-bit vs float): {tf_agree:.2%}; "
          f"mean |Δlogit| {float(torch.mean(torch.abs(lf - lq))):.4f}")

    # batched greedy serving (autoregressive: one flipped tie diverges the
    # suffix, so token-exact agreement is the stricter demo)
    prompts = {"tokens": next(data)["tokens"][: args.batch, :16]}
    max_len = 16 + args.gen
    eng_f = ServeEngine(cfg, state.params, max_len=max_len, compute_dtype=torch.float32,
                        device=dev)
    out_f = eng_f.generate(prompts, args.gen)
    eng_q = ServeEngine(cfg, qparams, max_len=max_len, compute_dtype=torch.float32, device=dev)
    out_q = eng_q.generate(prompts, args.gen)
    agree = float(np.mean(np.asarray(out_f) == np.asarray(out_q)))
    print(f"greedy generation {args.batch}×{args.gen}: token-exact agreement {agree:.2%}")

    # end-to-end packed serving: the pack_tree artifact IS the served model
    eng_p = ServeEngine.from_symog(cfg, state.params, state.symog, scfg,
                                   max_len=max_len, compute_dtype=torch.float32, device=dev)
    out_p = eng_p.generate(prompts, args.gen)
    exact = float(np.mean(np.asarray(out_p) == np.asarray(out_q)))
    fbytes = eng_f.weight_bytes()
    pbytes = eng_p.weight_bytes()
    print(f"packed 2-bit engine ({pbytes} weight bytes vs {fbytes} float, "
          f"{fbytes / pbytes:.1f}x smaller): token agreement with "
          f"hard-quantized serving {exact:.2%} (exact by construction)")
    return {"loss": float(m["loss"]), "rel_quant_error": float(qm["rel_quant_error"]),
            "tf_agree": tf_agree, "agree": agree, "packed_exact": exact,
            "weight_bytes": (fbytes, pbytes), "tokens_packed": np.asarray(out_p)}


if __name__ == "__main__":
    main()
