"""The port's numbering.py (a NumPy copy) vs the JAX package's, and the
``renumber`` command of both CLIs.

Every output must be identical: ``convert_chain_numbering`` arrays equal
(template chains, long and short loops, constant domains, gaps, a truncated
N-terminus, 40 seeded random chains with gaps and insertion duplicates),
the same anchor scores and detected schemes on the bundled antibody chains,
the same errors, and ``renumber_pdb`` files equal byte for byte with the
same summary and the same warning.  The port's ``renumber_pdb`` reads with
its own parser.
"""

import contextlib
import io
import json
import warnings

import numpy as np
import pytest

from protstruc_tpu import numbering as jnb
from protstruc_tpu.__main__ import main as jax_main
from protstruc_tpu.pdbio.parser import parse_pdb
from protstruc_tpu_torch import numbering as tnb
from protstruc_tpu_torch.__main__ import main
from tests.conftest import pdb_path

ANTIBODIES = (("6dc4.pdb", "H", "L"), ("15c8_HL.pdb", "H", "L"), ("1a3r_HL.pdb", "H", "L"),
              ("5cjx_HL.pdb", "H", "L"), ("1a6v_HL.pdb", "H", "L"))


def _fuzz_chain(seed):
    rng = np.random.RandomState(seed)
    ctype = ["heavy", "light"][seed % 2]
    top = 113 if ctype == "heavy" else 109
    nums = [n for n in range(1, top + 1)
            if n not in set(rng.choice(np.arange(2, top), rng.randint(0, 13), replace=False))]
    for _ in range(rng.randint(0, 4)):
        pos = int(rng.choice(nums))
        nums.insert(nums.index(pos), pos)
    return np.asarray(nums, np.int64), ctype


CHAINS = {
    "heavy_template": (np.arange(1, 114), "heavy"),
    "light_template": (np.arange(1, 110), "light"),
    "long_h3": (np.concatenate([np.arange(1, 100), np.full(8, 100), np.arange(101, 114)]),
                "heavy"),
    "short_l1": (np.concatenate([np.arange(1, 27), np.arange(30, 110)]), "light"),
    "constant_domain": (np.arange(1, 220), "heavy"),
    "fr3_gap": (np.concatenate([np.arange(1, 60), np.arange(66, 114)]), "heavy"),
    "truncated_nterm": (np.arange(4, 114), "heavy"),
    **{f"fuzz{s}": _fuzz_chain(s) for s in range(40)},
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_convert_chain_numbering_matches_jax(name):
    nums, ctype = CHAINS[name]
    for src, dst in (("chothia", "imgt"), ("kabat", "imgt"), ("chothia", "kabat")):
        ref = jnb.convert_chain_numbering(nums, ctype, src, dst)
        got = tnb.convert_chain_numbering(nums, ctype, src, dst)
        np.testing.assert_array_equal(got, ref, err_msg=f"{src}->{dst}")
        assert got.dtype == ref.dtype
        back_ref = jnb.convert_chain_numbering(ref, ctype, dst, src)
        np.testing.assert_array_equal(tnb.convert_chain_numbering(got, ctype, dst, src),
                                      back_ref, err_msg=f"{dst}->{src}")


@pytest.mark.parametrize("args,match", [
    (("antigen", "chothia", "imgt"), "chain_type"),
    (("heavy", "chothia", "martin"), "unknown scheme"),
])
def test_convert_errors_match_jax(args, match):
    nums = np.arange(1, 114)
    with pytest.raises(ValueError, match=match) as ref:
        jnb.convert_chain_numbering(nums, *args)
    with pytest.raises(ValueError, match=match) as got:
        tnb.convert_chain_numbering(nums, *args)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("fname,hid,lid", ANTIBODIES)
def test_detection_matches_jax(fname, hid, lid):
    p = parse_pdb(pdb_path(fname), chains=[hid, lid])
    for cid, ctype in ((hid, "heavy"), (lid, "light")):
        sel = p.chain_id_per_res == cid
        nums, letters = p.residue_number[sel].astype(np.int64), p.oneletter[sel]
        imgt = jnb.convert_chain_numbering(nums, ctype, "chothia", "imgt")
        for n in (nums, imgt):
            assert tnb.scheme_anchor_scores(n, letters, ctype) == \
                jnb.scheme_anchor_scores(n, letters, ctype)
            assert tnb.detect_numbering_scheme(n, letters, ctype) == \
                jnb.detect_numbering_scheme(n, letters, ctype)
            assert tnb.detect_numbering_scheme_strict(n, letters, ctype, "imgt", cid) == \
                jnb.detect_numbering_scheme_strict(n, letters, ctype, "imgt", cid)


def _renumber_both(tmp_path, src, tag, **kw):
    ref_out, got_out = str(tmp_path / f"{tag}_jax.pdb"), str(tmp_path / f"{tag}_port.pdb")
    ref = jnb.renumber_pdb(src, ref_out, **kw)
    got = tnb.renumber_pdb(src, got_out, **kw)
    assert got == ref
    assert open(got_out, "rb").read() == open(ref_out, "rb").read()
    return got_out


@pytest.mark.parametrize("fname,hid,lid", ANTIBODIES)
def test_renumber_pdb_matches_jax(tmp_path, fname, hid, lid):
    kw = dict(heavy_chain_id=hid, light_chain_id=lid)
    imgt = _renumber_both(tmp_path, pdb_path(fname), "imgt", to_scheme="imgt", **kw)
    _renumber_both(tmp_path, imgt, "back", to_scheme="chothia", **kw)
    _renumber_both(tmp_path, pdb_path(fname), "kabat", to_scheme="kabat", **kw)
    _renumber_both(tmp_path, pdb_path(fname), "heavy_only", to_scheme="imgt",
                   heavy_chain_id=hid, source_scheme="chothia")


def test_renumber_tie_warns_as_jax(tmp_path):
    """An IMGT light chain without its second anchor Cys ties the scores:
    both packages warn and leave it unconverted, with the same file."""
    imgt = str(tmp_path / "imgt.pdb")
    jnb.renumber_pdb(pdb_path("6dc4.pdb"), imgt, heavy_chain_id="H", light_chain_id="L")
    tied = str(tmp_path / "tied.pdb")
    with open(tied, "w") as fh:
        fh.writelines(ln for ln in open(imgt)
                      if not (ln.startswith("ATOM") and ln[21] == "L"
                              and int(ln[22:26]) == 104 and ln[17:20] == "CYS"))
    msgs = []
    for fn, out in ((jnb.renumber_pdb, "ref.pdb"), (tnb.renumber_pdb, "got.pdb")):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            s = fn(tied, str(tmp_path / out), heavy_chain_id="H", light_chain_id="L")
        msgs.append([str(x.message) for x in w])
        assert s["L"]["from"] == "imgt"
    assert msgs[0] == msgs[1] and any("cannot separate" in m for m in msgs[1])
    assert (tmp_path / "got.pdb").read_bytes() == (tmp_path / "ref.pdb").read_bytes()
    with pytest.raises(ValueError, match="not found"):
        tnb.renumber_pdb(tied, str(tmp_path / "x.pdb"), heavy_chain_id="Q")


def _cli(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("extra", [[], ["--to", "kabat", "--from", "chothia"], ["--light", "L"]])
def test_renumber_cli_matches_jax(tmp_path, extra):
    """``python -m protstruc_tpu_torch renumber`` prints the JAX CLI's JSON
    line (the output path aside) and writes the same file."""
    src = pdb_path("15c8_HL.pdb")
    heavy = [] if extra == ["--light", "L"] else ["--heavy", "H"]
    ref_rc, ref = _cli(jax_main, ["renumber", src, str(tmp_path / "ref.pdb")] + heavy + extra)
    got_rc, got = _cli(main, ["renumber", src, str(tmp_path / "got.pdb")] + heavy + extra)
    assert ref_rc == got_rc == 0
    ref, got = json.loads(ref), json.loads(got)
    assert got["output"] == str(tmp_path / "got.pdb")
    assert got["chains"] == ref["chains"]
    assert (tmp_path / "got.pdb").read_bytes() == (tmp_path / "ref.pdb").read_bytes()
    with pytest.raises(SystemExit, match="--heavy and/or --light"):
        main(["renumber", src, str(tmp_path / "x.pdb")])
