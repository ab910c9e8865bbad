"""Train the cross-modal mapping from paired features (the port's twin of
the root ``create_mapping.py``).

    python -m multimodalpromptretrieval_tpu_torch.create_mapping \\
        --features feats.npz [--epochs 30] [--batch-size 64] [--lr 1e-4] \\
        [--out mapping.npz] [--viz mapping.pdf] [--device cpu]

``feats.npz`` holds ``clip_image_features`` (N, D) and ``t5_text_features``
(N, D). The mapping (Linear -> ReLU -> Linear plus a learned
``logit_scale``) is fitted with symmetric InfoNCE, its top-5 image -> text
retrieval accuracy printed, and it is written to ``--out`` in the JAX
package's npz format: the ``mapping_checkpoint`` config key of either
package loads it. ``--viz`` writes a PCA scatter (needs matplotlib). It runs
on the card unless ``--device`` names another device (``--device cpu``).
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--features", required=True)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--out", default="mapping.npz")
    p.add_argument("--viz", default=None)
    p.add_argument("--device",
                   help="torch device to run on (default: the CUDA card)")
    args = p.parse_args(argv)

    from multimodalpromptretrieval_tpu_torch.train.checkpoint import (
        save_mapping,
    )
    from multimodalpromptretrieval_tpu_torch.train.mapping import (
        retrieval_accuracy,
        train_mapping,
        visualize_mapping,
    )

    with np.load(args.features) as z:
        img = z["clip_image_features"].astype(np.float32)
        txt = z["t5_text_features"].astype(np.float32)
    params = train_mapping(img, txt, epochs=args.epochs,
                           batch_size=args.batch_size, lr=args.lr,
                           quiet=False, device=args.device)
    acc = retrieval_accuracy(params, img, txt, k=5)
    print(f"top-5 image->text retrieval accuracy: {acc:.3f}")
    save_mapping(args.out, params.cpu())
    if args.viz:
        visualize_mapping(params, img, txt, out_path=args.viz)
        print(f"wrote {args.viz}")


if __name__ == "__main__":
    main()
