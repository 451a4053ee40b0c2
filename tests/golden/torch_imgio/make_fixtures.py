"""Write the image-format fixtures of the PyTorch port's tests and of
``chip_smoke.py``'s phase 29, with Pillow's readings of them.

    python tests/golden/torch_imgio/make_fixtures.py

Writes one small file for each variant of ``tests/image_files.py``'s
``CATALOGUE`` (seeded by its name), ``pillow.npz`` with Pillow's
``np.asarray(Image.open(f))``, ``convert("L")`` and ``convert("RGB")`` of
each (keys ``<name>/samples``, ``<name>/L``, ``<name>/RGB``; ``L`` and
``RGB`` are left out where they equal the samples, and listed under
``refuses`` where Pillow's ``convert`` raises), the 1280x720 files of
``image_files.LARGE`` (a progressive JPEG, a lossy WebP, a CMYK JPEG and
a CCITT Group 4 TIFF, which the card's host cannot write without
Pillow) with digests of Pillow's arrays (the arrays would not fit), and
``fixtures.json`` naming the files and the Pillow version.
"""

import json
import pathlib
import sys

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))
sys.path.insert(0, str(HERE.parents[2]))
import image_files  # noqa: E402


def main():
    import PIL
    from PIL import Image

    for old in HERE.iterdir():
        if old.suffix in (".png", ".bmp", ".tif", ".jpg", ".npz", ".json",
                          ".pnm", ".pgm", ".ppm", ".pbm", ".pfm", ".gif",
                          ".webp"):
            old.unlink()
    files, arrays, refuses = {}, {}, {}
    for name in sorted(image_files.CATALOGUE):
        ext, data = image_files.make(name)
        path = HERE / f"{name}{ext}"
        path.write_bytes(data)
        files[name] = path.name
        im = Image.open(path)
        samples = np.asarray(im)
        arrays[f"{name}/samples"] = samples
        for mode in ("L", "RGB"):
            try:
                a = np.asarray(im.convert(mode))
            except ValueError:
                refuses.setdefault(name, []).append(mode)
                continue
            if not (a.dtype == samples.dtype and a.shape == samples.shape
                    and np.array_equal(a, samples)):
                arrays[f"{name}/{mode}"] = a
    np.savez_compressed(HERE / "pillow.npz", **arrays)
    large = {}
    for name, (ext, make) in image_files.LARGE.items():
        big = HERE / f"{name}{ext}"
        big.write_bytes(make())
        im = Image.open(big)
        large[name] = {
            "file": big.name,
            "samples": image_files.digest(np.asarray(im)),
            "L": image_files.digest(np.asarray(im.convert("L")))}
    (HERE / "fixtures.json").write_text(json.dumps(
        {"pillow": PIL.__version__, "files": files, "large": large,
         "refuses": refuses}, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    main()
