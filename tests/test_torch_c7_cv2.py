"""ROADMAP C.7 on the CPU: ``chip_smoke.py`` phase 29, which holds
``image.imresize`` and the resizing augmenters to ``cv2.resize`` at the
bars of ``tests/test_torch_image.py`` (nearest equal in uint8, the other
interpolations within 1, float32 within 1e-4, the augmenters within 1).
It runs the JAX package nowhere: ``cv2.resize`` is what the JAX package's
``imresize`` calls.  Where cv2 is not installed it skips here; on the
card's host the phase fails instead.  And the runners of phase 30 on
the card, ``tools/torch_kvstore_chip.py`` and
``tools/torch_kvstore_host_probe.py``, import nothing of JAX."""
import ast
import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_phase_29_holds_imresize_and_augmenters_to_cv2():
    pytest.importorskip("cv2")
    out = _chip_smoke().phase_cv2_resize("cpu")
    assert out["cases"] == 40
    assert out["imresize_max_abs_diff"]["uint8"][0] == 0
    assert max(out["imresize_max_abs_diff"]["uint8"].values()) <= 1
    assert max(out["imresize_max_abs_diff"]["float32"].values()) <= 1e-4
    assert max(out["augmenters_max_abs_diff"].values()) <= 1
    assert len(out["augmenters_max_abs_diff"]) == 6


def test_phase_29_fails_without_cv2(monkeypatch):
    """No cv2 on the host: the phase raises instead of skipping."""
    smoke = _chip_smoke()
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "cv2"
                        else real(name, *a))
    with pytest.raises(AssertionError, match="cv2 is not installed"):
        smoke.phase_cv2_resize("cpu")


@pytest.mark.parametrize("tool,imports", [
    ("torch_kvstore_chip.py", {"json", "os", "sys", "chip_smoke"}),
    ("torch_kvstore_host_probe.py",
     {"gc", "json", "os", "sys", "time", "torch", "chip_smoke"})])
def test_kvstore_chip_tool_imports_no_jax(tool, imports):
    path = os.path.join(REPO, "tools", tool)
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert names == imports
