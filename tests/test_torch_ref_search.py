"""The reference's batteries of search and the on-disk format, run against
the port: `tests/test_index_e2e.py`, `tests/test_golden_format.py` and
`tests/test_target_recall.py`.

`port_battery` loads each with its imports of the JAX package pointed at
`nextplaid_tpu_torch`, and with these edits:
- every file: `create_index` and `DeviceIndex.load` given device="cpu";
  `import jax.numpy as jnp` -> `import torch`, and `jnp.asarray(` ->
  `torch.as_tensor(` (the port's functions take tensors).
- test_index_e2e: `.dtype.name == "int8"` / `"bfloat16"` -> `.dtype ==
  torch.int8` / `torch.bfloat16`; in `test_int8_kernel_interpret_matches_scan`
  the inline query quantization is written in torch (`torch.amax`,
  `torch.where`, `torch.clip`, `torch.round`, `.to(torch.int8)` for the
  jnp calls) and the kernel call loses `interpret=True` (on CPU tensors the
  port's wrapper runs the kernel's plain version).
Left out:
- test_index_e2e `test_ranged_exact_scores_merge_to_full`: the range-split
  exact scan (`exact_all_scores(doc_lo=, doc_range=)`) exists for the JAX
  package's split dispatch, which the port leaves out by design (ROADMAP,
  "Not ported, by design": `SPLIT_DISPATCH_SLOTS`).
"""

from tests.test_torch_api import expose, port_battery

_JNP = (("import jax.numpy as jnp\n", "import torch\n"), ("jnp.asarray(", "torch.as_tensor("))
_CPU = ("create_index", "DeviceIndex.load")

_e2e = port_battery(
    "test_index_e2e",
    *_JNP,
    ('.dtype.name == "int8"', ".dtype == torch.int8"),
    ('.dtype.name == "bfloat16"', ".dtype == torch.bfloat16"),
    ("maxabs = jnp.max(jnp.abs(qf32), axis=-1)", "maxabs = torch.amax(torch.abs(qf32), dim=-1)"),
    ("qscale = jnp.where(maxabs > 0, maxabs / 127.0, 0.0)",
     "qscale = torch.where(maxabs > 0, maxabs / 127.0, 0.0)"),
    ("qi8 = jnp.clip(\n        jnp.round(qf32 / jnp.where(qscale > 0, qscale, 1.0)[:, None]),\n"
     "        -127, 127,\n    ).astype(jnp.int8)",
     "qi8 = torch.clip(\n        torch.round(qf32 / torch.where(qscale > 0, qscale, 1.0)[:, None]),\n"
     "        -127, 127,\n    ).to(torch.int8)"),
    ("            tq=tq,\n            interpret=True,\n", "            tq=tq,\n"),
    cpu_calls=_CPU,
)
_golden = port_battery("test_golden_format", *_JNP, cpu_calls=("DeviceIndex.load",))
_target = port_battery("test_target_recall", cpu_calls=_CPU)

LEFT_OUT = {"test_index_e2e": ("test_ranged_exact_scores_merge_to_full",)}
BATTERIES = {
    "test_index_e2e": (_e2e, expose(_e2e, globals(), LEFT_OUT["test_index_e2e"])),
    "test_golden_format": (_golden, expose(_golden, globals())),
    "test_target_recall": (_target, expose(_target, globals())),
}


def test_battery_lists_every_reference_test():
    counts = {"test_index_e2e": 26, "test_golden_format": 5, "test_target_recall": 7}
    for name, (mod, tests) in BATTERIES.items():
        assert not set(tests) & set(LEFT_OUT.get(name, ()))
        assert len(tests) + len(LEFT_OUT.get(name, ())) == counts[name], name
