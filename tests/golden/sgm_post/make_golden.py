"""Write tests/golden/sgm_post/jax_post.npz: the JAX package's SGM post
(``simplestereo_tpu.passive.sgm._sgm_post``) of each kind of
``tests/sgm_post_cases.py`` under each of its OPTIONS, frame by frame,
with the stored path sums and the digests of the generated ones (see that
module). Runs on the CPU:

    python tests/golden/sgm_post/make_golden.py
"""

import pathlib
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))
sys.path.insert(0, str(HERE.parents[2]))
import sgm_post_cases as cases  # noqa: E402


def jax_post(S, kw):
    """JAX's post of a (..., H, W, D) S, one frame at a time."""
    import jax.numpy as jnp
    from simplestereo_tpu.passive import sgm as jsgm
    frames = S.reshape(-1, *S.shape[-3:])
    return np.stack([np.asarray(jsgm._sgm_post(jnp.asarray(f), **kw))
                     for f in frames]).reshape(S.shape[:-1])


def path_sum(min_disp):
    """JAX path sum of a noise pair with a true shift of 3, D = 9."""
    from simplestereo_tpu.passive import sgm as jsgm
    rng = np.random.default_rng(12)
    img1 = rng.integers(0, 256, (24, 40, 3), np.uint8)
    img2 = np.roll(img1, -3, axis=1)
    return np.asarray(jsgm._aggregate(jsgm._sgm_cost(
        img1, img2, min_disp=min_disp, num_disp=9, block_size=3,
        prefilter_cap=63.0), 24.0, 96.0, 8))


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    out = {}
    for kind in cases.KINDS:
        if kind in cases.STORED:
            md = cases.STORED[kind]
            S = out[f"S/{kind}"] = path_sum(md)
        else:
            S, md = cases.generate(kind)
            out[f"sha256/{kind}"] = np.array(cases.digest(S))
        out[f"map/{kind}"] = np.stack([
            jax_post(S, kw) for kw in cases.options(md, S.shape[-1])])
    np.savez_compressed(cases.GOLDEN, **out)


if __name__ == "__main__":
    main()
