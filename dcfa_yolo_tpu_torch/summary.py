"""Model summary of the port, the counterpart of the root `summary.py`: the
module tree at depth 1, the parameter count and the FLOPs of one forward at
the given input size.

    python -m dcfa_yolo_tpu_torch.summary [--input-shape H W] [--phi n]
        [--num-classes 1] [--device cuda|cpu]

FLOPs come from `torch.utils.flop_counter` (`utils/profiling.py::
forward_flops`): convolutions and matrix products at 2 FLOPs per
multiply-add, the reference's MACs×2 convention (`summary.py:23-31`), and no
elementwise, pooling or reduction ops, unlike the XLA cost analysis the JAX
package prints.  Runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input-shape", type=int, nargs=2, default=[640, 640])
    p.add_argument("--phi", default="n")
    p.add_argument("--num-classes", type=int, default=1)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from dcfa_yolo_tpu_torch.config import ModelConfig
    from dcfa_yolo_tpu_torch.models.yolo import count_params, init_model
    from dcfa_yolo_tpu_torch.utils.profiling import forward_flops

    cfg = ModelConfig(num_classes=args.num_classes, phi=args.phi,
                      input_shape=tuple(args.input_shape))
    model = init_model(cfg, 0, args.device)
    h, w = cfg.input_shape
    print(f"{'module':<24} {'type':<18} {'params':>10}")
    for name, child in model.named_children():
        print(f"{name:<24} {type(child).__name__:<18} {count_params(child):>10,}")
    n_params = count_params(model)
    flops = forward_flops(model)
    print(f"Total params: {n_params:,} ({n_params / 1e6:.2f}M)")
    print(f"Total GFLOPs: {flops / 1e9:.3f}G (torch.utils.flop_counter: convs "
          f"and matmuls at 2 FLOPs per multiply-add, no elementwise ops; "
          f"input {h}x{w} pair)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
