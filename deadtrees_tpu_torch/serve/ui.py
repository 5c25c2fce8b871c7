"""Streamlit frontend of the segmentation service.

Counterpart of ``deadtrees_tpu.serve.ui``, copied: it holds no JAX. Upload
an image, POST it to the backend ``/segmentation`` endpoint
(``serve/server.py``), and show source + prediction either side by side or
through the juxtapose slider (the knightlab CDN component the reference
embeds), plus the prediction stats from the response headers. Run with:

    streamlit run deadtrees_tpu_torch/serve/ui.py

Every piece of logic — the HTTP round trip (:func:`process`), header
parsing (:func:`stats_from_headers`), the stats markdown
(:func:`stats_markdown`), the slider HTML (:func:`juxtapose_html`) and the
page flow (:func:`render`) — is streamlit-free or takes the ``st`` module
as a parameter, so the frontend is tested without the streamlit runtime.
:func:`main` is the thin runtime shim. Slider images embed as base64 data
URIs instead of files written into streamlit's static dir. The inference
types are the port service's own: ``"torch"`` (a checkpoint) and
``"exported"`` (an artifact of ``infer/export.py``).
"""

from __future__ import annotations

import base64
import io
import os
from typing import Dict, Optional

DISPLAY_MODES = ("Side-by-side", "Slider")
MODEL_TYPES = ("torch", "exported")


def backend_url() -> str:
    """Compose-network default, overridable for local runs
    (reference ui.py:82: http://backend:8000/segmentation)."""
    return os.environ.get("BACKEND_URL", "http://backend:8000/segmentation")


def process(file_bytes: bytes, server_url: str,
            model_type: Optional[str] = None) -> Dict:
    """POST the upload to the backend; return {'mask': bytes, 'stats': dict}.

    Counterpart of reference ``process`` (ui.py:93-104) — stdlib urllib
    multipart so the frontend has no hard requests dependency.
    """
    import urllib.request

    url = server_url
    if model_type:
        sep = "&" if "?" in url else "?"
        url = f"{url}{sep}model_type={model_type}"

    boundary = "deadtreesboundary"
    body = (
        f"--{boundary}\r\n"
        'Content-Disposition: form-data; name="file"; filename="upload"\r\n'
        "Content-Type: application/octet-stream\r\n\r\n"
    ).encode() + file_bytes + f"\r\n--{boundary}--\r\n".encode()
    req = urllib.request.Request(
        url, data=body,
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"},
    )
    with urllib.request.urlopen(req, timeout=300) as resp:
        return {
            "mask": resp.read(),
            "stats": stats_from_headers(dict(resp.headers)),
        }


def stats_from_headers(headers: Dict[str, str]) -> Dict[str, str]:
    """``X-``-prefixed response headers → {stat: value} (serve/models.py)."""
    return {
        k[2:].lower().replace("-", "_"): v
        for k, v in headers.items()
        if k.lower().startswith("x-")
    }


def stats_markdown(stats: Dict[str, str]) -> str:
    """Stats block matching the reference's markdown (ui.py:152-162)."""
    lines = ["### Stats 📊"]
    if "model_name" in stats:
        lines.append(f"Model: **{stats['model_name']}**")
    if "model_type" in stats:
        lines.append(f"Format: **{stats['model_type']}**")
    if "fraction" in stats:
        lines.append(
            "Percentage of dead trees detected: "
            f"**{float(stats['fraction']) * 100:.2f}%**"
        )
    if "elapsed" in stats:
        lines.append(f"Inference duration: **{float(stats['elapsed']):.1f}sec**")
    return "  \n".join(lines)


def _data_uri(png_bytes: bytes) -> str:
    return "data:image/png;base64," + base64.b64encode(png_bytes).decode()


def juxtapose_html(img1: str, img2: str, height: int = 600) -> str:
    """Knightlab juxtapose slider embed (reference ui.py:16-74): CSS + JS
    from the CDN, a JXSlider over [source, prediction] starting at 50%."""
    cdn = "https://cdn.knightlab.com/libs/juxtapose/latest"
    return f"""\
<link rel="stylesheet" href="{cdn}/css/juxtapose.css">
<script src="{cdn}/js/juxtapose.min.js"></script>
<div id="deadtrees-juxtapose" style="width: 95%; height: {height}px; margin: 1px;"></div>
<script>
slider = new juxtapose.JXSlider('#deadtrees-juxtapose',
    [
        {{src: "{img1}", label: 'source'}},
        {{src: "{img2}", label: 'prediction'}}
    ],
    {{
        animate: true,
        showLabels: true,
        showCredits: true,
        startingPosition: "50%",
        makeResponsive: true
    }});
</script>
"""


def _to_png_bytes(image_bytes: bytes) -> bytes:
    """Normalize any uploaded/returned image to RGB PNG bytes."""
    from PIL import Image

    img = Image.open(io.BytesIO(image_bytes)).convert("RGB")
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def render(st, components_html, *, backend: Optional[str] = None) -> Optional[Dict]:
    """The page flow (reference ui.py:107-169), parameterized on the
    streamlit module (``st``) and the components.html callable so tests
    drive it with fakes. Returns the processed result (or None when no
    upload/button)."""
    backend = backend or backend_url()

    st.set_page_config(page_title="DeadTrees", page_icon="🌲")
    st.title("🌲☠️🌲 DeadTrees segmentation")
    st.write(
        "Obtain semantic segmentation maps of the image in input via our "
        "segmentation network on the GPU. Visit this URL at port 8000 for REST API."
    )

    col1, col2 = st.columns(2)
    model_type = col1.selectbox("Inference type", list(MODEL_TYPES))
    vtype = col2.radio("Display", DISPLAY_MODES, index=1)

    uploaded = st.file_uploader("Insert Image")
    if not st.button("Get Segmentation Map"):
        return None
    if uploaded is None:
        st.write("Insert an image!")
        return None

    file_bytes = uploaded.read() if hasattr(uploaded, "read") else uploaded
    result = process(file_bytes, backend, model_type)

    src_png = _to_png_bytes(file_bytes)
    mask_png = _to_png_bytes(result["mask"])

    if vtype == "Side-by-side":
        c1, c2 = st.columns(2)
        c1.header("Source")
        c1.image(src_png, use_column_width=True)
        c2.header("Prediction")
        c2.image(mask_png, use_column_width=True)
    else:
        components_html(
            juxtapose_html(_data_uri(src_png), _data_uri(mask_png), height=600),
            height=600,
        )

    st.markdown(stats_markdown(result["stats"]))
    return result


def main() -> None:  # pragma: no cover - needs streamlit runtime
    import streamlit as st
    import streamlit.components.v1 as components

    render(st, components.html)


if __name__ == "__main__":  # pragma: no cover
    main()
