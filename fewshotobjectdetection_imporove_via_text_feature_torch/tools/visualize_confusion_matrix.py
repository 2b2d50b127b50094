"""The cosine similarity of a VOC split's class embeddings, as a heatmap:

    python -m fewshotobjectdetection_imporove_via_text_feature_torch.tools.visualize_confusion_matrix \\
        [--model glove|clip] [--split 1] [--root datasets] \\
        [--output Similarity_matrix.png]

Counterpart of the repository's ``visualize_confusion_matrix.py`` (ref
visualize_confusion_matrix.py:10-73), over this package's
``utils/class_embedding.get_class_embed`` (``{root}/{model}/{class}.txt``,
synthetic vectors where a file is missing): the same matrix and figure,
drawn with matplotlib where it is installed, else written as CSV beside
the requested name.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..data.builtin_meta import PASCAL_VOC_ALL_CATEGORIES
from ..utils.class_embedding import get_class_embed


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="glove", choices=["glove", "clip"])
    p.add_argument("--split", type=int, default=1)
    p.add_argument("--root", default="datasets")
    p.add_argument("--output", default="Similarity_matrix.png")
    args = p.parse_args(argv)

    names = PASCAL_VOC_ALL_CATEGORIES[args.split]
    bank = get_class_embed(names, args.model, root=args.root)
    norm = bank / np.linalg.norm(bank, axis=1, keepdims=True)
    sim = norm @ norm.T

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(10, 8))
        im = ax.imshow(sim, cmap="viridis")
        ax.set_xticks(range(len(names)))
        ax.set_yticks(range(len(names)))
        ax.set_xticklabels(names, rotation=90)
        ax.set_yticklabels(names)
        for i in range(len(names)):
            for j in range(len(names)):
                ax.text(j, i, f"{sim[i, j]:.2f}", ha="center", va="center",
                        fontsize=6, color="w")
        fig.colorbar(im)
        fig.tight_layout()
        fig.savefig(args.output, dpi=150)
        plt.close(fig)
        print(f"wrote {args.output}")
        return args.output
    except ImportError:
        out = args.output.rsplit(".", 1)[0] + ".csv"
        np.savetxt(out, sim, delimiter=",", header=",".join(names))
        print(f"matplotlib unavailable; wrote {out}")
        return out


if __name__ == "__main__":
    main()
