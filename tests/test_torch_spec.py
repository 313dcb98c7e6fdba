"""The port's spec layer equals the reference's.

``repro_torch.core.stencil``/``streams``/``isa`` are framework-free copies
of ``repro.core``'s; for every paper spec and pipeline under all four
boundaries, plus forced ``"dense"``, the taps, halo, structure,
``compute_terms`` and assembled ``Program.words`` must match exactly.
"""
import pytest

from repro.core import (DOMAIN_SIZES as J_DOMAINS, PAPER_PIPELINES as J_PIPES,
                        PAPER_STENCILS as J_SPECS, assemble as j_assemble,
                        assemble_pipeline as j_assemble_pipeline,
                        parse_boundary as j_parse_boundary)
from repro_torch import (DOMAIN_SIZES, PAPER_PIPELINES, PAPER_STENCILS,
                         SegmentConfig, assemble, assemble_pipeline,
                         parse_boundary, spec_from_reference)

BOUNDARIES = ["zero", "constant(0.75)", "periodic", "reflect"]


def _terms(spec):
    terms = spec.factorization.compute_terms
    if terms is None:
        return None
    return tuple(tuple((f.axis, f.offsets, f.coeffs) for f in t.factors)
                 for t in terms)


def _all_terms(spec):
    terms = spec.factorization.terms
    return None if terms is None else tuple(
        tuple((f.axis, f.offsets, f.coeffs) for f in t.factors)
        for t in terms)


def _same_spec(port, ref):
    assert port.name == ref.name and port.ndim == ref.ndim
    assert port.taps == ref.taps
    assert port.halo == ref.halo
    assert port.boundary == ref.boundary
    assert (port.boundary_mode, port.boundary_value) == \
        (ref.boundary_mode, ref.boundary_value)
    assert port.structure == ref.structure
    assert port.factorization.structure == ref.factorization.structure
    assert port.factorization.tap_ops == ref.factorization.tap_ops
    assert _terms(port) == _terms(ref)
    assert _all_terms(port) == _all_terms(ref)
    assert port.flops_per_point() == ref.flops_per_point()
    assert port.structured_flops_per_point() == \
        ref.structured_flops_per_point()


@pytest.mark.parametrize("structure", ["auto", "dense"])
@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("name", list(J_SPECS))
def test_paper_specs_match_reference(name, boundary, structure):
    ref = J_SPECS[name].with_boundary(boundary)
    port = PAPER_STENCILS[name].with_boundary(boundary)
    if structure == "dense":
        ref, port = ref.with_structure("dense"), port.with_structure("dense")
    _same_spec(port, ref)
    assert spec_from_reference(ref) == port
    assert assemble(port).words == j_assemble(ref).words
    assert assemble(port).structured_n_instrs == \
        j_assemble(ref).structured_n_instrs


@pytest.mark.parametrize("boundary", [None] + BOUNDARIES)
@pytest.mark.parametrize("name", list(J_PIPES))
def test_paper_pipelines_match_reference(name, boundary):
    ref, port = J_PIPES[name], PAPER_PIPELINES[name]
    if boundary is not None:
        ref, port = ref.with_boundary(boundary), port.with_boundary(boundary)
    assert port.stage_names == ref.stage_names
    assert port.halo == ref.halo and port.fusable == ref.fusable
    for p, r in zip(port.stages, ref.stages):
        _same_spec(p, r)
    assert spec_from_reference(ref) == port
    assert assemble_pipeline(port).words == j_assemble_pipeline(ref).words


def test_tables_and_parsing_match_reference():
    assert {k: dict(v) for k, v in DOMAIN_SIZES.items()} == \
        {k: dict(v) for k, v in J_DOMAINS.items()}
    for b in BOUNDARIES + ["constant(-2.5)"]:
        assert parse_boundary(b) == j_parse_boundary(b)
    with pytest.raises(ValueError):
        parse_boundary("wrap")
    assert SegmentConfig().block_elems == 128 * 1024 // 8
