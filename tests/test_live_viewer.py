"""Live HTTP viewer (io/live_viewer.py) — the headless replacement for the
reference's Pangolin/raw-GL scene window (run_euroc_single_thread.cpp:131-148,
glwindow/scenewindow.cpp:46-175)."""
import json
import urllib.request

import numpy as np

from msckf_stereo_c.io.live_viewer import LiveViewer


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as r:
        return r.status, r.read()


def test_live_viewer_serves_state():
    v = LiveViewer(port=0)  # ephemeral port
    port = v.start()
    try:
        status, page = _get(port, "/")
        assert status == 200
        page = page.decode()
        # The orbit-camera interaction model of scenewindow.cpp.
        assert "canvas" in page and "wheel" in page and "mousemove" in page

        v.publish(np.array([[0.0, 0.0, 0.0], [1.0, 2.0, 3.0]]),
                  points=np.array([[5.0, 5.0, 1.0]]), frame=2)
        status, body = _get(port, "/state.json")
        assert status == 200
        s = json.loads(body)
        assert s["frame"] == 2 and s["seq"] == 1
        assert s["path"] == [[0.0, 0.0, 0.0], [1.0, 2.0, 3.0]]
        assert s["points"] == [[5.0, 5.0, 1.0]]

        # Appends accumulate; landmark cloud is replaced.
        v.publish(np.array([[2.0, 2.0, 2.0]]), points=np.zeros((0, 3)))
        s = json.loads(_get(port, "/state.json")[1])
        assert len(s["path"]) == 3 and s["points"] == []

        status, _ = _get(port, "/state.json?seq=1")
        assert status == 200

        # Ring-buffer cap holds.
        v2_cap = LiveViewer(port=0, max_path=4)
        v2_cap.publish(np.zeros((10, 3)))
        assert len(json.loads(v2_cap.state_json())["path"]) == 4
    finally:
        v.stop()


def test_404():
    v = LiveViewer(port=0)
    port = v.start()
    try:
        try:
            _get(port, "/nope")
            raise AssertionError("expected 404")
        except urllib.error.HTTPError as e:
            assert e.code == 404
    finally:
        v.stop()
