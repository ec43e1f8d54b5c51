// Fast PDB ATOM/HETATM record scanner of protstruc_tpu_torch.
//
// Replaces the NumPy per-line field extraction of
// protstruc_tpu_torch/pdbio/parser.py (_read_model1_lines +
// _parse_atom_records) with one pass over the raw byte buffer: record
// filtering (model 1 only), fixed-column field extraction and float parsing
// all happen here.  The residue walk and tidy logic stay in Python (cheap,
// per residue).  A copy of the JAX package's native/pdb_parser.cpp: keep the
// two in step.
//
// C ABI (ctypes, protstruc_tpu_torch/pdbio/native.py):
//   ps_parse_atoms(data, len, atom_name[4n], altloc[n], res_name[3n],
//                  chain[n], res_num[n], icode[n], xyz[3n], max_records)
//     -> number of records written, or -1 on overflow.
//
// Built at first use by pdbio/native.py:
//   g++ -O3 -shared -fPIC -std=c++17 pdb_parser.cpp -o libpspdb-<hash>.so

#include <cstdint>
#include <cstring>
#include <cstdlib>

namespace {

// Parse a fixed-width PDB coordinate field (%8.3f style): optional spaces,
// sign, digits, dot, digits. Faster than strtod and no locale issues.
inline float parse_fixed_float(const char* p, int width) {
    int i = 0;
    while (i < width && p[i] == ' ') ++i;
    bool neg = false;
    if (i < width && (p[i] == '-' || p[i] == '+')) {
        neg = p[i] == '-';
        ++i;
    }
    long long int_part = 0;
    while (i < width && p[i] >= '0' && p[i] <= '9') {
        int_part = int_part * 10 + (p[i] - '0');
        ++i;
    }
    double value = static_cast<double>(int_part);
    if (i < width && p[i] == '.') {
        ++i;
        double scale = 0.1;
        while (i < width && p[i] >= '0' && p[i] <= '9') {
            value += (p[i] - '0') * scale;
            scale *= 0.1;
            ++i;
        }
    }
    return static_cast<float>(neg ? -value : value);
}

inline int32_t parse_fixed_int(const char* p, int width) {
    int i = 0;
    while (i < width && p[i] == ' ') ++i;
    bool neg = false;
    if (i < width && (p[i] == '-' || p[i] == '+')) {
        neg = p[i] == '-';
        ++i;
    }
    int32_t v = 0;
    while (i < width && p[i] >= '0' && p[i] <= '9') {
        v = v * 10 + (p[i] - '0');
        ++i;
    }
    return neg ? -v : v;
}

}  // namespace

extern "C" {

int64_t ps_parse_atoms(
    const char* data, int64_t len,
    char* atom_name,   // n * 4, space-padded
    char* altloc,      // n
    char* res_name,    // n * 3, space-padded
    char* chain,       // n
    int32_t* res_num,  // n
    char* icode,       // n
    float* xyz,        // n * 3
    int64_t max_records) {
    int64_t n = 0;
    int64_t pos = 0;
    int model_count = 0;

    while (pos < len) {
        // find end of line
        int64_t eol = pos;
        while (eol < len && data[eol] != '\n') ++eol;
        int64_t line_len = eol - pos;
        if (line_len > 0 && data[pos + line_len - 1] == '\r') --line_len;
        const char* line = data + pos;
        pos = eol + 1;

        if (line_len < 6) continue;

        if (line[0] == 'M' && line_len >= 5 && memcmp(line, "MODEL", 5) == 0) {
            if (++model_count > 1) break;
            continue;
        }
        if (line[0] == 'E' && line_len >= 6 && memcmp(line, "ENDMDL", 6) == 0) {
            break;
        }

        bool is_atom = memcmp(line, "ATOM  ", 6) == 0;
        bool is_het = !is_atom && memcmp(line, "HETATM", 6) == 0;
        if (!is_atom && !is_het) continue;
        if (line_len < 54) continue;  // needs full coordinate block

        if (n >= max_records) return -1;

        memcpy(atom_name + n * 4, line + 12, 4);
        altloc[n] = line[16];
        memcpy(res_name + n * 3, line + 17, 3);
        chain[n] = line[21];
        res_num[n] = parse_fixed_int(line + 22, 4);
        icode[n] = line[26];
        xyz[n * 3 + 0] = parse_fixed_float(line + 30, 8);
        xyz[n * 3 + 1] = parse_fixed_float(line + 38, 8);
        xyz[n * 3 + 2] = parse_fixed_float(line + 46, 8);
        ++n;
    }
    return n;
}

}  // extern "C"
