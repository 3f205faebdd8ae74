"""Evaluate a trained model: render every view of a dataset and report
PSNR (and SSIM).

No reference counterpart (the reference only logs MSE losses); this is the
measurement tool for matched-PSNR comparisons.  Prints
per-view and mean PSNR in dB (plus SSIM, Wang et al. 2004) over u8
pixels, with final summary lines ``mean_psnr=<dB>`` / ``mean_ssim=<s>``
for scripting.
"""

import os

import numpy as np

from ..data.dataset import load_dataset
from ..utils.metrics import psnr, ssim
from .render_nerf import RenderSession, base_argparser
from ..utils.device import use_compile_cache


def main(argv=None):
    use_compile_cache()
    parser = base_argparser()
    parser.add_argument(
        "--max_views", type=int, default=None, help="evaluate only the first N views"
    )
    parser.add_argument("data_dir", type=str)
    args = parser.parse_args(argv)
    # RenderSession wants metadata_json; point it into the dataset dir.
    args.metadata_json = os.path.join(args.data_dir, "metadata.json")

    data = load_dataset(args.data_dir)
    views = (
        data.views[: args.max_views] if args.max_views is not None else data.views
    )

    from ..utils.progress import progress

    session = RenderSession(args)
    scores = []
    ssims = []
    for i, view in enumerate(progress(views, desc="views")):
        gt = view.image()
        # Explicit per-view resolution: the jitted frame fn caches one
        # executable per distinct ray count, so mixed-resolution datasets
        # compile once per resolution, not per view.
        pred = session.render_view(view, width=gt.shape[1], height=gt.shape[0])
        session.images.clear()
        score = psnr(pred, gt)
        scores.append(score)
        # SSIM needs an 11-pixel window; tiny debug views skip it.
        s = ssim(pred, gt) if min(gt.shape[:2]) >= 11 else None
        ssims.append(s)
        extra = f" ssim={s:.4f}" if s is not None else ""
        print(f"view {i}: psnr={score:.2f} dB{extra}", flush=True)

    print(f"mean_psnr={np.mean(scores):.3f}")
    if all(s is not None for s in ssims) and ssims:
        print(f"mean_ssim={np.mean(ssims):.4f}")


if __name__ == "__main__":
    main()
