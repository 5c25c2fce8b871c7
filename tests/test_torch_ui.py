"""The port's Streamlit frontend against the JAX package's, with a stand-in ``st``.

Streamlit is in neither the CPU image nor the card's, so ``ui.main()``
(the runtime shim) is not run here; everything else is, as
``tests/test_ui.py`` runs the JAX frontend: the slider HTML, the header
parsing and the stats markdown equal to the JAX functions' output, and the
page flow (``render``) with ``tests/test_ui.py``'s fake ``st`` against the
port's own stdlib server on the CPU, whose ``process()`` round trip gives
the service's own PNG mask.
"""

import io
import threading

import numpy as np
import pytest
from PIL import Image

from deadtrees_tpu.serve import ui as jax_ui
from deadtrees_tpu_torch.serve import SegmentationService, serve_stdlib, ui
from tests.test_torch_serve import ckpt  # noqa: F401 - the fixture
from tests.test_ui import _FakeSt, _upload_bytes


def test_static_pieces_match_jax():
    for args in (("SRC.png", "PRED.png"), ("a", "b")):
        assert ui.juxtapose_html(*args, height=432) == jax_ui.juxtapose_html(*args, height=432)
    headers = {"X-Model-Name": "bestmodel", "X-Model-Type": "torch", "X-Fraction": "0.125",
               "X-Elapsed": "1.5", "Content-Type": "image/png"}
    stats = ui.stats_from_headers(headers)
    assert stats == jax_ui.stats_from_headers(headers)
    assert ui.stats_markdown(stats) == jax_ui.stats_markdown(stats)
    assert "Format: **torch**" in ui.stats_markdown(stats)
    assert ui.DISPLAY_MODES == jax_ui.DISPLAY_MODES and ui.DISPLAY_MODES[1] == "Slider"
    assert ui.MODEL_TYPES == ("torch", "exported")
    assert ui.backend_url() == jax_ui.backend_url()


@pytest.fixture(scope="module")
def backend(ckpt):  # noqa: F811
    service = SegmentationService(ckpt, device="cpu")
    server = serve_stdlib(service, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield service, f"http://127.0.0.1:{server.server_address[1]}/segmentation"
    server.shutdown()
    server.server_close()
    service.close()
    thread.join(timeout=30)


def test_process_round_trip(backend):
    service, url = backend
    upload = _upload_bytes()
    result = ui.process(upload, url, "torch")
    mask = np.asarray(Image.open(io.BytesIO(result["mask"])))
    body, _ = service.segment(upload, "torch")
    np.testing.assert_array_equal(mask, np.asarray(Image.open(io.BytesIO(body))))
    assert mask.shape == (32, 32)
    assert result["stats"]["model_type"] == "torch"
    assert 0.0 <= float(result["stats"]["fraction"]) <= 1.0


@pytest.mark.parametrize("display", ["Side-by-side", "Slider"])
def test_render(backend, display):
    st = _FakeSt(io.BytesIO(_upload_bytes(1)), {"display": display})
    shown = []
    assert ui.render(st, lambda html, **kw: shown.append(html), backend=backend[1]) is not None
    if display == "Slider":
        assert len(shown) == 1 and shown[0].count("data:image/png;base64,") == 2
        assert "images" not in st.rec
    else:
        assert st.rec["headers"] == ["Source", "Prediction"] and len(st.rec["images"]) == 2
        assert not shown
    assert any("Stats" in m for m in st.rec["markdown"])


def test_render_without_upload_prompts(backend):
    st = _FakeSt(None, {"display": "Slider"})
    assert ui.render(st, lambda html, **kw: None, backend=backend[1]) is None
    assert "Insert an image!" in st.rec["writes"]
