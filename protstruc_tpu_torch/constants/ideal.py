"""Ideal backbone geometry constants (lengths in Angstrom, angles in radians).

These are the standard idealized peptide-backbone bond lengths, planar angles
and dihedrals used for frame construction and structure reconstruction.
Parity: dohlee/protstruc constants/ideal.py:1-50.  A verbatim copy of
``protstruc_tpu/constants/ideal.py`` (the port never imports the JAX package).
"""

# --- bond lengths / pseudo-bond lengths -----------------------------------
NA = 1.458   # N - Ca
AN = NA      # Ca - N
AC = 1.523   # Ca - C
CA = AC      # C - Ca
AB = 1.522   # Ca - Cb
BA = AB      # Cb - Ca
C_N = 1.329  # C - N (peptide bond to next residue)
NB = 2.447   # N .. Cb (pseudo)
BN = NB
CB = 2.499   # C .. Cb (pseudo)
BC = CB
NC = 2.460   # N .. C (pseudo)
CN = NC
CO = 1.231   # C - O
OC = CO

# --- planar angles ----------------------------------------------------------
ANC = 0.615  # Ca-N-C
NAB = 1.927  # N-Ca-Cb
BAN = NAB
NAC = 1.937  # N-Ca-C
CAN = NAC
ACO = 2.108  # Ca-C-O
OCA = ACO

# --- dihedral angles --------------------------------------------------------
BANC = -2.143  # Cb-Ca-N-C
NACO = -3.142  # N-Ca-C-O (peptide-bond planarity)

as_dict = {
    "NA": NA, "AN": AN, "AC": AC, "CA": CA, "AB": AB, "BA": BA,
    "C_N": C_N, "NB": NB, "BN": BN, "CB": CB, "BC": BC, "NC": NC, "CN": CN,
    "ANC": ANC, "NAB": NAB, "BAN": BAN, "BANC": BANC,
}
