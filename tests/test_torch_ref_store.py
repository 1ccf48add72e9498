"""The reference's batteries of the metadata store, full-text search, the
add/delete stress cycles and the encoder's vocabulary, run against the port.

`port_battery` loads each reference file with its imports of the JAX package
pointed at `nextplaid_tpu_torch`, with these edits:
- `tests/test_filtering.py`, `tests/test_text_search.py`: none (the stores
  are host code).
- `tests/test_stress_cycles.py`: `update_or_create_with_metadata` and
  `DeviceIndex.load` given device="cpu".
- `tests/test_encoder_vocab.py`: `Colbert` given device="cpu". The port's
  colbert module imports `os`, which the JAX package's lacks
  (nextplaid_tpu/encoder/colbert.py:194): these five tests fail against the
  JAX package and pass against the port.
No test is left out.
"""

from tests.test_torch_api import expose, port_battery

_filtering = port_battery("test_filtering")
_text_search = port_battery("test_text_search")
_stress = port_battery(
    "test_stress_cycles", cpu_calls=("update_or_create_with_metadata", "DeviceIndex.load"))
_vocab = port_battery("test_encoder_vocab", cpu_calls=("Colbert",))

BATTERIES = {
    "test_filtering": (_filtering, expose(_filtering, globals())),
    "test_text_search": (_text_search, expose(_text_search, globals())),
    "test_stress_cycles": (_stress, expose(_stress, globals())),
    "test_encoder_vocab": (_vocab, expose(_vocab, globals())),
}
LEFT_OUT = {}


def test_battery_lists_every_reference_test():
    counts = {"test_filtering": 21, "test_text_search": 20, "test_stress_cycles": 1,
              "test_encoder_vocab": 5}
    for name, (mod, tests) in BATTERIES.items():
        assert not set(tests) & set(LEFT_OUT.get(name, ()))
        assert len(tests) + len(LEFT_OUT.get(name, ())) == counts[name], name
