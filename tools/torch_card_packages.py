"""What the card's machine offers the port's drawing and video modules.

The JAX package draws its 3D views with matplotlib (Agg) and encodes JPEG
and GIF frames with PIL (``mv3d_tpu/utils/viz3d.py``, ``utils/video.py``,
``cli/render.py``). Nothing can be installed on the machine with the
card, so the port may use a package there only if it is present. Prints
the Python version, whether matplotlib imports and renders a PNG through
Agg, PIL's version and whether it writes JPEG, GIF and PNG. Run from the
repository root on that machine:

    python3 tools/torch_card_packages.py
"""

import importlib
import io
import sys


def main() -> int:
    print("python", sys.version.split()[0])
    try:
        matplotlib = importlib.import_module("matplotlib")
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig = plt.figure()
        plt.plot([0, 1])
        buf = io.BytesIO()
        fig.savefig(buf, format="png")
        print("matplotlib", matplotlib.__version__, "Agg png bytes",
              len(buf.getvalue()))
    except ImportError as e:
        print("matplotlib missing:", e)
    try:
        from PIL import Image
    except ImportError as e:
        print("PIL missing:", e)
        return 0
    import PIL
    print("PIL", PIL.__version__)
    im = Image.new("RGB", (16, 16), (10, 20, 30))
    for fmt in ("JPEG", "GIF", "PNG"):
        buf = io.BytesIO()
        try:
            im.save(buf, format=fmt)
            print("PIL", fmt, "bytes", len(buf.getvalue()))
        except (OSError, KeyError) as e:
            print("PIL", fmt, "cannot be written:", e)
    return 0


if __name__ == "__main__":
    sys.exit(main())
