"""Train a ~100M-param qwen3-family model for a few hundred steps on the
PyTorch/CUDA port, with mid-run checkpoint + restore (kill-resume drill).

The port's twin of ``examples/train_lm.py``: the same configs, steps,
drill and printed lines.  In bf16 on the card each attention layer runs
the flash forward kernel and both flash backward kernels.  Default runs a
reduced config and step count; --full does the whole thing.

  PYTHONPATH=src python examples/train_lm_torch.py [--full]        # card
  PYTHONPATH=src python examples/train_lm_torch.py --device cpu
"""
import argparse
import dataclasses
import tempfile

from repro_torch.configs import get_config
from repro_torch.launch.train import train_loop


def sizes(full: bool) -> tuple:
    """(config, steps, batch, seq) of the example's two sizes."""
    base = get_config("qwen3-1.7b")
    if full:
        cfg = dataclasses.replace(base, name="qwen3-100m", num_layers=8,
                                  d_model=512, num_heads=8, num_kv_heads=4,
                                  head_dim=64, d_ff=2048,
                                  vocab_size=151936)   # ~100M params
        return cfg, 300, 4, 256
    cfg = dataclasses.replace(base, name="qwen3-20m", num_layers=4,
                              d_model=256, num_heads=8, num_kv_heads=4,
                              head_dim=32, d_ff=1024, vocab_size=32768)
    return cfg, 200, 8, 128


def main(argv=None, steps: int = None, batch: int = None,
         seq: int = None) -> dict:
    """Run the drill (``steps``, ``batch`` and ``seq`` override the
    size's); return the lines printed, the train loop's log lines among
    them, and its restarts, events, final step and logged losses."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="json 100M params x 300 steps (slow on CPU)")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (no card: raises)")
    args = ap.parse_args(argv)
    lines = []

    def say(line: str) -> None:
        print(line, flush=True)
        lines.append(line)

    cfg, n_steps, n_batch, n_seq = sizes(args.full)
    steps, batch, seq = (steps or n_steps, batch or n_batch, seq or n_seq)
    say(f"model {cfg.name}: ~{cfg.param_count()/1e6:.0f}M params, "
        f"{steps} steps")

    with tempfile.TemporaryDirectory() as d:
        # train the first half, "crash", resume from the checkpoint
        out1 = train_loop(cfg, steps=steps, batch=batch, seq=seq,
                          ckpt_dir=d, save_every=steps // 4,
                          fail_at=steps // 2, log=say, device=args.device)
        say(f"restarts: {out1['restarts']}  events: {out1['events']}")
        first = out1["losses"][0][1]
        last = out1["losses"][-1][1]
        say(f"loss {first:.3f} -> {last:.3f} over {out1['final_step']} "
            f"steps ({out1['wall_s']:.0f}s)")
        if not last < first:
            raise RuntimeError(f"loss should decrease: {first} -> {last}")
    return {"lines": lines, "restarts": out1["restarts"],
            "events": out1["events"], "final_step": out1["final_step"],
            "losses": out1["losses"], "wall_s": out1["wall_s"]}


if __name__ == "__main__":
    main()
