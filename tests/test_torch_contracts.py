"""The port's tensor contracts (cyclonus_tpu_torch/utils/contracts.py)
against the reference's, on the CPU: the same spec grammar, the same
declarations on the encoder dataclasses and the kernel entry points (the
reference's uint32 IPs declared int64, as they travel on the device),
and the same malformed arrays — numpy arrays, and CPU torch tensors on
the port's side — rejected by both packages with the same message naming
the same field.  With CYCLONUS_SHAPE_CHECK unset the decorators return
the class or function itself; armed (a subprocess, since the flag is read
at import) the port validates its encodings and kernel arguments on a
real engine run and its contract counter moves."""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from cyclonus_tpu.engine import encoding as ref_encoding
from cyclonus_tpu.engine import kernel as ref_kernel
from cyclonus_tpu.engine import cidrspace as ref_cidrspace
from cyclonus_tpu.utils import contracts as ref_contracts
from cyclonus_tpu_torch.engine import cidrspace, encoding, kernel
from cyclonus_tpu_torch.utils import contracts

from test_torch_engine import REPO

#: the checked dataclasses of both packages, by name
CHECKED = ("ClusterEncoding", "_DirectionEncoding", "TierDirectionEncoding",
           "PolicyEncoding", "PodClasses")

#: the kernel entry points with parameter contracts
KERNELS = ("selector_match", "direction_precompute", "port_spec_allows",
           "lpm_partition_signature", "gather_class_grids")

#: the reference's uint32 parameters the port declares as int64
WIDENED = {("direction_precompute", "pod_ip"), ("lpm_partition_signature", "pod_ip"),
           ("lpm_partition_signature", "pmask"), ("lpm_partition_signature", "pbases")}

SPECS = ["(N, L) int32", "(N,) uint32", "[S, E, V] int32", "(G,) int8", "(N,)",
         "(3, K) bool", "() float32", "(A, 128) bfloat16"]
BAD_SPECS = ["N, L int32", "(N L) int32", "(N,) int31", "(N-1,) int32"]


def _spec_tuple(spec):
    return (spec.dims, spec.dtype, spec.sentinel, spec.mask)


class TestGrammar:
    @pytest.mark.parametrize("text", SPECS)
    def test_spec_parses_as_the_reference(self, text):
        for sentinel, mask in ((None, None), ("-1=pad,0=inert", "pod_ip_valid")):
            got = contracts.parse_spec(text, sentinel=sentinel, mask=mask)
            want = ref_contracts.parse_spec(text, sentinel=sentinel, mask=mask)
            assert _spec_tuple(got) == _spec_tuple(want)
            assert got.render() == want.render()

    @pytest.mark.parametrize("text", BAD_SPECS)
    def test_bad_spec_raises_in_both(self, text):
        with pytest.raises(ValueError) as ref_err:
            ref_contracts.parse_spec(text)
        with pytest.raises(ValueError) as err:
            contracts.parse_spec(text)
        assert str(err.value) == str(ref_err.value)

    @pytest.mark.parametrize("name", ["bool", "int8", "int32", "int64", "uint8", "float32",
                                      "float64"])
    def test_numpy_and_torch_dtypes_share_one_name(self, name):
        assert contracts._canon_dtype(np.dtype(name)) == name
        assert contracts._canon_dtype(getattr(torch, name)) == name
        assert ref_contracts._canon_dtype(np.dtype(name)) == name


class TestDeclarations:
    @pytest.mark.parametrize("cls", CHECKED)
    def test_dataclass_fields_match_the_reference(self, cls):
        """The same tensor fields, with the same spec, sentinels and
        masks: the encodings are host numpy arrays in both packages."""
        def fields(mod):
            return {f.name: _spec_tuple(f.metadata["tensor"])
                    for f in dataclasses.fields(getattr(mod, cls)) if "tensor" in f.metadata}

        got, want = fields(encoding), fields(ref_encoding)
        assert got and got == want

    def test_cidrspace_fields_match_the_reference(self):
        def fields(mod):
            return {f.name: _spec_tuple(f.metadata["tensor"])
                    for f in dataclasses.fields(mod.CidrSpace) if "tensor" in f.metadata}

        assert fields(cidrspace) == fields(ref_cidrspace)

    @pytest.mark.parametrize("fn", KERNELS)
    def test_kernel_contracts_match_the_reference(self, fn):
        """The reference's parameter contracts, with its uint32 IPs and
        CIDR operands declared int64 (the port widens them on the
        device, carry.py)."""
        got = getattr(kernel, fn).__tensor_contracts__
        want = getattr(ref_kernel, fn).__tensor_contracts__
        assert set(got) == set(want)
        for name, spec in want.items():
            dims, dtype, sentinel, mask = _spec_tuple(spec)
            if (fn, name) in WIDENED:
                assert dtype == "uint32"
                dtype = "int64"
            assert _spec_tuple(got[name]) == (dims, dtype, sentinel, mask), name


class TestStripped:
    """CYCLONUS_SHAPE_CHECK unset (the test process never sets it): no
    wrapper anywhere, the lint metadata still attached."""

    def test_flag_is_off(self):
        assert not contracts.CHECK and not ref_contracts.CHECK

    @pytest.mark.parametrize("cls", CHECKED)
    def test_checked_classes_are_untouched(self, cls):
        assert not hasattr(getattr(encoding, cls).__init__, "__wrapped__")
        assert not hasattr(cidrspace.CidrSpace.__init__, "__wrapped__")

    @pytest.mark.parametrize("fn", KERNELS)
    def test_kernels_are_the_functions_themselves(self, fn):
        f = getattr(kernel, fn)
        assert not hasattr(f, "__wrapped__")
        assert hasattr(f, "__tensor_contracts__")

    def test_decorators_return_their_argument(self):
        class C:
            pass

        def f(x):
            return x

        assert contracts.checked(C) is C
        assert contracts.args(x="(N,) int32")(f) is f
        assert f.__tensor_contracts__["x"].dims == ("N",)


def _cluster(mod, **over):
    """A well-formed one-pod ClusterEncoding of `mod`, with fields
    replaced by `over`."""
    kw = dict(
        vocab=mod._Vocab(), pod_keys=["ns/a", "ns/b"],
        pod_ns_id=np.zeros(2, np.int32),
        pod_kv=np.full((2, 3), -1, np.int32),
        pod_key=np.full((2, 3), -1, np.int32),
        pod_ip=np.zeros(2, np.uint32),
        pod_ip_valid=np.ones(2, bool),
        pod_ips=["10.0.0.1", "10.0.0.2"],
        ns_kv=np.full((1, 2), -1, np.int32),
        ns_key=np.full((1, 2), -1, np.int32),
    )
    kw.update(over)
    return mod.ClusterEncoding(**kw)


#: malformed fields: (case, field, numpy value)
MALFORMED = [
    ("rank", "pod_ns_id", np.zeros((2, 1), np.int32)),
    ("dtype", "pod_ns_id", np.zeros(2, np.int64)),
    ("dtype_bool", "pod_ip_valid", np.ones(2, np.int8)),
    ("symbol", "pod_key", np.full((3, 3), -1, np.int32)),
    ("symbol_inner", "pod_key", np.full((2, 4), -1, np.int32)),
    ("uint_ip", "pod_ip", np.zeros(2, np.int32)),
]


class TestViolations:
    @pytest.mark.parametrize("case,field,value", MALFORMED, ids=[m[0] for m in MALFORMED])
    def test_numpy_violation_matches_the_reference(self, case, field, value):
        """The same malformed array makes both packages raise
        ContractViolation, word for word, naming the same field."""
        with pytest.raises(ref_contracts.ContractViolation) as ref_err:
            ref_contracts.validate_dataclass(_cluster(ref_encoding, **{field: value}))
        with pytest.raises(contracts.ContractViolation) as err:
            contracts.validate_dataclass(_cluster(encoding, **{field: value}))
        assert str(err.value) == str(ref_err.value)
        assert f"ClusterEncoding.{field}" in str(err.value)

    @pytest.mark.parametrize("case,field,value", MALFORMED, ids=[m[0] for m in MALFORMED])
    def test_torch_violation_matches_the_reference(self, case, field, value):
        """A CPU torch tensor of the same shape and dtype as the numpy
        array (torch has no uint32: the int32 pod_ip case only) raises
        the message the reference raises for the array."""
        with pytest.raises(ref_contracts.ContractViolation) as ref_err:
            ref_contracts.validate_dataclass(_cluster(ref_encoding, **{field: value}))
        with pytest.raises(contracts.ContractViolation) as err:
            contracts.validate_dataclass(
                _cluster(encoding, **{field: torch.from_numpy(value)})
            )
        assert str(err.value) == str(ref_err.value)

    def test_well_formed_torch_tensors_pass(self):
        ok = _cluster(encoding, pod_ns_id=torch.zeros(2, dtype=torch.int32),
                      pod_ip_valid=torch.ones(2, dtype=torch.bool))
        before = contracts.CHECKS
        contracts.validate_dataclass(ok)
        assert contracts.CHECKS == before + 7
        contracts.validate_dataclass(_cluster(encoding))
        ref_contracts.validate_dataclass(_cluster(ref_encoding))

    def test_non_array_is_named(self):
        with pytest.raises(contracts.ContractViolation, match=r"ClusterEncoding\.pod_ns_id: "
                           r"declared \(N,\) int32 but observed a non-array list"):
            contracts.validate_dataclass(_cluster(encoding, pod_ns_id=[0, 0]))

    def test_values_are_never_read(self):
        """Only shape and dtype: a meta tensor (no storage, so any value
        read would raise) validates."""
        meta = {k: torch.empty(v.shape, dtype=torch.int32, device="meta")
                for k, v in (("pod_ns_id", np.zeros(2)), ("pod_kv", np.zeros((2, 3))),
                             ("pod_key", np.zeros((2, 3))))}
        contracts.validate_dataclass(_cluster(encoding, **meta))


ARMED = textwrap.dedent(
    """
    import json, os, sys
    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
    from cyclonus_tpu_torch import synthetic
    from cyclonus_tpu_torch.engine import PortCase, TorchPolicyEngine, encoding, kernel
    from cyclonus_tpu_torch.matcher import build_network_policies
    from cyclonus_tpu_torch.telemetry.metrics import REGISTRY
    from cyclonus_tpu_torch.utils import contracts
    from cyclonus_tpu.engine import encoding as ref_encoding
    from cyclonus_tpu.engine import kernel as ref_kernel
    from cyclonus_tpu.utils import contracts as ref_contracts
    import random

    out = {"check": contracts.CHECK, "ref_check": ref_contracts.CHECK}
    out["wrapped"] = hasattr(encoding.ClusterEncoding.__init__, "__wrapped__") and all(
        hasattr(getattr(kernel, f), "__wrapped__")
        for f in ("selector_match", "direction_precompute", "port_spec_allows",
                  "lpm_partition_signature", "gather_class_grids"))
    pods, namespaces, policies = synthetic.build_synthetic(96, 12, random.Random(5))
    policy = build_network_policies(True, policies)
    cases = [PortCase(80, "serve-80-tcp", "TCP"), PortCase(81, "", "UDP")]
    counts = {}
    for cc in ("0", "1"):
        eng = TorchPolicyEngine(policy, pods, namespaces, device="cpu", class_compress=cc)
        counts[cc] = eng.evaluate_grid_counts(cases)
        eng.evaluate_grid(cases).combined
    out["counts_equal"] = counts["0"] == counts["1"]
    out["checks"] = contracts.CHECKS
    out["counter_registered"] = "cyclonus_tpu_contract_checks_total" in REGISTRY.render_prometheus()

    def both(make_ref, make_port):
        msgs = []
        for make, exc in ((make_ref, ref_contracts.ContractViolation),
                          (make_port, contracts.ContractViolation)):
            try:
                make()
            except exc as e:
                msgs.append(str(e))
            else:
                msgs.append(None)
        return msgs

    def cluster(mod, **over):
        kw = dict(vocab=mod._Vocab(), pod_keys=["ns/a"], pod_ns_id=np.zeros((1, 2), np.int32),
                  pod_kv=np.full((1, 1), -1, np.int32), pod_key=np.full((1, 1), -1, np.int32),
                  pod_ip=np.zeros(1, np.uint32), pod_ip_valid=np.zeros(1, bool),
                  pod_ips=["10.0.0.1"], ns_kv=np.full((1, 1), -1, np.int32),
                  ns_key=np.full((1, 1), -1, np.int32))
        kw.update(over)
        return mod.ClusterEncoding(**kw)

    out["construct"] = both(lambda: cluster(ref_encoding), lambda: cluster(encoding))
    s, n, m = 3, 4, 2
    out["kernel_ip"] = both(
        lambda: ref_kernel.direction_precompute(
            {}, np.zeros((s, n), bool), np.zeros((s, m), bool), np.zeros(n, np.int32),
            np.zeros(n, np.int32), np.zeros(n, bool)),
        lambda: kernel.direction_precompute(
            {}, torch.zeros((s, n), dtype=torch.bool), torch.zeros((s, m), dtype=torch.bool),
            torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32),
            torch.zeros(n, dtype=torch.bool)),
    )
    out["kernel_symbol"] = both(
        lambda: ref_kernel.port_spec_allows(
            {}, np.zeros(2, np.int32), np.zeros(3, np.int32), np.zeros(2, np.int32)),
        lambda: kernel.port_spec_allows(
            {}, torch.zeros(2, dtype=torch.int32), torch.zeros(3, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32)),
    )
    print("ARMED " + json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def armed():
    env = dict(os.environ, CYCLONUS_SHAPE_CHECK="1", JAX_PLATFORMS="cpu",
               CYCLONUS_AOT_CACHE="0")
    proc = subprocess.run([sys.executable, "-c", ARMED], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("ARMED ")][-1]
    return json.loads(line[len("ARMED "):])


class TestArmed:
    def test_decorators_wrap_under_the_flag(self, armed):
        assert armed["check"] and armed["ref_check"] and armed["wrapped"]

    def test_engine_run_validates_and_counts(self, armed):
        """Both routes of a real engine on the CPU pass every contract,
        give equal counts, and the counter moves and registers."""
        assert armed["counts_equal"]
        assert armed["checks"] > 0
        assert armed["counter_registered"]

    def test_construction_raises_as_the_reference(self, armed):
        ref_msg, msg = armed["construct"]
        assert ref_msg is not None and msg == ref_msg
        assert "ClusterEncoding.pod_ns_id" in msg and "(1, 2)" in msg

    def test_kernel_dtype_violation_names_the_parameter(self, armed):
        """An int32 pod_ip: the reference declares uint32, the port
        int64; both name direction_precompute(pod_ip)."""
        ref_msg, msg = armed["kernel_ip"]
        assert ref_msg == ("direction_precompute(pod_ip): declared dtype uint32 but observed "
                           "int32 (shape (4,))")
        assert msg == ("direction_precompute(pod_ip): declared dtype int64 but observed "
                       "int32 (shape (4,))")

    def test_kernel_symbol_clash_matches_the_reference(self, armed):
        ref_msg, msg = armed["kernel_symbol"]
        assert ref_msg is not None and msg == ref_msg
        assert "port_spec_allows(q_name): symbol Q = 3 here but 2 elsewhere" in msg
