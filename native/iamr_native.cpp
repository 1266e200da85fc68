// iamr_tpu native runtime components (C++17).
//
// JAX replacement for the host-side C++ machinery the reference
// gets from AMReX:
//   * berger_rigoutsos: tag clustering into efficient box covers
//     (AMReX Src/AmrCore cluster algorithm used by Amr::regrid; reference
//     call path NS_error.cpp errorEst -> external clustering)
//   * write_fab / read_fab: AMReX native-format FArrayBox binary I/O, the
//     hot inner loop of VisMF plotfile/checkpoint writing (reference
//     NavierStokesBase.cpp:856-897 checkPoint via VisMF)
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).
//
// Build: make -C native  (g++ -O3 -fPIC -shared)

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Box {
  int lo[3];
  int hi[3];  // inclusive
};

// count tags inside box
static int64_t count_tags(const uint8_t* tags, const int64_t* stride,
                          const Box& b, int dim) {
  int64_t n = 0;
  int zlo = dim > 2 ? b.lo[2] : 0, zhi = dim > 2 ? b.hi[2] : 0;
  for (int i = b.lo[0]; i <= b.hi[0]; ++i)
    for (int j = b.lo[1]; j <= b.hi[1]; ++j)
      for (int k = zlo; k <= zhi; ++k)
        n += tags[i * stride[0] + j * stride[1] + k * stride[2]];
  return n;
}

static int64_t box_volume(const Box& b, int dim) {
  int64_t v = 1;
  for (int d = 0; d < dim; ++d) v *= (b.hi[d] - b.lo[d] + 1);
  return v;
}

// shrink box to the bounding box of its tags; returns false if empty
static bool shrink_to_tags(const uint8_t* tags, const int64_t* stride,
                           Box& b, int dim) {
  Box nb;
  for (int d = 0; d < dim; ++d) {
    nb.lo[d] = b.hi[d] + 1;
    nb.hi[d] = b.lo[d] - 1;
  }
  int zlo = dim > 2 ? b.lo[2] : 0, zhi = dim > 2 ? b.hi[2] : 0;
  for (int i = b.lo[0]; i <= b.hi[0]; ++i)
    for (int j = b.lo[1]; j <= b.hi[1]; ++j)
      for (int k = zlo; k <= zhi; ++k)
        if (tags[i * stride[0] + j * stride[1] + k * stride[2]]) {
          int idx[3] = {i, j, k};
          for (int d = 0; d < dim; ++d) {
            nb.lo[d] = std::min(nb.lo[d], idx[d]);
            nb.hi[d] = std::max(nb.hi[d], idx[d]);
          }
        }
  if (nb.lo[0] > nb.hi[0]) return false;
  if (dim < 3) {
    nb.lo[2] = nb.hi[2] = 0;
  }
  b = nb;
  return true;
}

// signature (tag histogram) along dimension d
static void signature(const uint8_t* tags, const int64_t* stride,
                      const Box& b, int dim, int d, std::vector<int64_t>& sig) {
  sig.assign(b.hi[d] - b.lo[d] + 1, 0);
  int zlo = dim > 2 ? b.lo[2] : 0, zhi = dim > 2 ? b.hi[2] : 0;
  for (int i = b.lo[0]; i <= b.hi[0]; ++i)
    for (int j = b.lo[1]; j <= b.hi[1]; ++j)
      for (int k = zlo; k <= zhi; ++k) {
        if (tags[i * stride[0] + j * stride[1] + k * stride[2]]) {
          int idx[3] = {i, j, k};
          sig[idx[d] - b.lo[d]]++;
        }
      }
}

// Berger-Rigoutsos recursive split: holes first, then strongest inflection,
// then midpoint of the longest side.
static void br_split(const uint8_t* tags, const int64_t* stride, Box b,
                     int dim, int min_width, double min_eff,
                     std::vector<Box>& out, int depth) {
  if (!shrink_to_tags(tags, stride, b, dim)) return;
  int64_t nt = count_tags(tags, stride, b, dim);
  double eff = double(nt) / double(box_volume(b, dim));
  bool small_enough = true;
  for (int d = 0; d < dim; ++d)
    if (b.hi[d] - b.lo[d] + 1 > 2 * min_width) small_enough = false;
  if (eff >= min_eff || depth > 24 || small_enough) {
    out.push_back(b);
    return;
  }

  // 1) look for a hole (zero plane) in any signature
  std::vector<int64_t> sig;
  int best_d = -1, best_cut = -1;
  for (int d = 0; d < dim && best_d < 0; ++d) {
    int len = b.hi[d] - b.lo[d] + 1;
    if (len < 2 * min_width) continue;
    signature(tags, stride, b, dim, d, sig);
    for (int c = min_width; c <= len - min_width; ++c) {
      if (sig[c] == 0) {
        best_d = d;
        best_cut = c;
        break;
      }
    }
  }
  // 2) strongest inflection point in the Laplacian of the signature
  if (best_d < 0) {
    int64_t best_mag = -1;
    for (int d = 0; d < dim; ++d) {
      int len = b.hi[d] - b.lo[d] + 1;
      if (len < 2 * min_width) continue;
      signature(tags, stride, b, dim, d, sig);
      std::vector<int64_t> lap(len, 0);
      for (int c = 1; c + 1 < len; ++c)
        lap[c] = sig[c + 1] - 2 * sig[c] + sig[c - 1];
      for (int c = min_width; c + 1 <= len - min_width; ++c) {
        if ((lap[c] > 0 && lap[c + 1] < 0) || (lap[c] < 0 && lap[c + 1] > 0)) {
          int64_t mag = std::abs(lap[c + 1] - lap[c]);
          if (mag > best_mag) {
            best_mag = mag;
            best_d = d;
            best_cut = c + 1;
          }
        }
      }
    }
  }
  // 3) fallback: midpoint of the longest splittable side
  if (best_d < 0) {
    int longest = -1;
    for (int d = 0; d < dim; ++d) {
      int len = b.hi[d] - b.lo[d] + 1;
      if (len >= 2 * min_width && len > longest) {
        longest = len;
        best_d = d;
        best_cut = len / 2;
      }
    }
  }
  if (best_d < 0) {
    out.push_back(b);
    return;
  }

  Box left = b, right = b;
  left.hi[best_d] = b.lo[best_d] + best_cut - 1;
  right.lo[best_d] = b.lo[best_d] + best_cut;
  br_split(tags, stride, left, dim, min_width, min_eff, out, depth + 1);
  br_split(tags, stride, right, dim, min_width, min_eff, out, depth + 1);
}

}  // namespace

extern "C" {

// Berger-Rigoutsos clustering.
// tags: uint8 C-order array of `shape` (dim entries, dim in {2,3}).
// out_boxes: int32 buffer of capacity max_boxes * 2*dim, filled as
// lo[0..dim) hi[0..dim) per box (hi inclusive). Returns the number of boxes
// (clipped to max_boxes) or -1 on bad input.
int iamr_br_cluster(const uint8_t* tags, const int64_t* shape, int dim,
                    int min_width, double min_eff, int max_boxes,
                    int32_t* out_boxes) {
  if (dim < 2 || dim > 3 || min_width < 1) return -1;
  int64_t stride[3] = {0, 0, 1};
  if (dim == 2) {
    stride[0] = shape[1];
    stride[1] = 1;
    stride[2] = 0;  // unused; k loop runs k=0 only
    // make k index a no-op
    stride[2] = 0;
  } else {
    stride[0] = shape[1] * shape[2];
    stride[1] = shape[2];
    stride[2] = 1;
  }
  Box root;
  for (int d = 0; d < 3; ++d) {
    root.lo[d] = 0;
    root.hi[d] = d < dim ? int(shape[d]) - 1 : 0;
  }
  std::vector<Box> boxes;
  br_split(tags, stride, root, dim, min_width, min_eff, boxes, 0);
  int n = std::min<int>(boxes.size(), max_boxes);
  for (int i = 0; i < n; ++i) {
    for (int d = 0; d < dim; ++d) {
      out_boxes[i * 2 * dim + d] = boxes[i].lo[d];
      out_boxes[i * 2 * dim + dim + d] = boxes[i].hi[d];
    }
  }
  return n;
}

// Write one FArrayBox in AMReX native format (header line + per-component
// Fortran-order float64 payload). data: C-order (ncomp, n[0], ..., n[dim-1]).
// Returns the byte offset of the FAB HEADER (what VisMF records in the _H
// FabOnDisk line: AMReX's VisMF::readFAB seeks there and re-parses the
// header) or -1 on failure. `append`: 0 = truncate, 1 = append (multi-fab
// files). `typ`: per-dim box index type (0 cell, 1 node), may be null.
int64_t iamr_write_fab(const char* path, const double* data,
                       const int64_t* n, int dim, int ncomp,
                       const int32_t* lo, const int32_t* hi, int append,
                       const int32_t* typ) {
  FILE* f = std::fopen(path, append ? "ab" : "wb");
  if (!f) return -1;
  int64_t offset = std::ftell(f);
  // header: FAB ((8, (64 11 52 0 1 12 0 1023)),(8, (8 7 6 5 4 3 2 1)))
  //         ((lo) (hi) (type)) ncomp
  std::string hdr = "FAB ((8, (64 11 52 0 1 12 0 1023)),(8, (8 7 6 5 4 3 2 1)))((";
  for (int d = 0; d < dim; ++d) hdr += (d ? "," : "") + std::to_string(lo[d]);
  hdr += ") (";
  for (int d = 0; d < dim; ++d) hdr += (d ? "," : "") + std::to_string(hi[d]);
  hdr += ") (";
  for (int d = 0; d < dim; ++d)
    hdr += (d ? "," : "") + std::to_string(typ ? typ[d] : 0);
  hdr += ")) " + std::to_string(ncomp) + "\n";
  std::fwrite(hdr.data(), 1, hdr.size(), f);

  int64_t npts = 1;
  for (int d = 0; d < dim; ++d) npts *= n[d];

  // transpose C-order -> Fortran-order per component, buffered
  std::vector<double> buf(npts);
  for (int c = 0; c < ncomp; ++c) {
    const double* src = data + int64_t(c) * npts;
    if (dim == 2) {
      const int64_t nx = n[0], ny = n[1];
      for (int64_t j = 0; j < ny; ++j)
        for (int64_t i = 0; i < nx; ++i) buf[j * nx + i] = src[i * ny + j];
    } else {
      const int64_t nx = n[0], ny = n[1], nz = n[2];
      for (int64_t k = 0; k < nz; ++k)
        for (int64_t j = 0; j < ny; ++j)
          for (int64_t i = 0; i < nx; ++i)
            buf[(k * ny + j) * nx + i] = src[(i * ny + j) * nz + k];
    }
    std::fwrite(buf.data(), sizeof(double), npts, f);
  }
  std::fclose(f);
  return offset;
}

// Read the payload of a FAB back into C-order (ncomp, n...). `offset` is
// the FAB-header position (VisMF semantics; the header line is skipped),
// or a legacy direct-payload offset (detected by the missing FAB magic).
// Returns 0 on success.
int iamr_read_fab(const char* path, int64_t offset, double* data,
                  const int64_t* n, int dim, int ncomp) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  if (std::fseek(f, long(offset), SEEK_SET) != 0) {
    std::fclose(f);
    return -1;
  }
  char magic[4];
  if (std::fread(magic, 1, 4, f) == 4 && std::memcmp(magic, "FAB ", 4) == 0) {
    int ch;
    while ((ch = std::fgetc(f)) != EOF && ch != '\n') {
    }
  } else if (std::fseek(f, long(offset), SEEK_SET) != 0) {
    std::fclose(f);
    return -1;
  }
  int64_t npts = 1;
  for (int d = 0; d < dim; ++d) npts *= n[d];
  std::vector<double> buf(npts);
  for (int c = 0; c < ncomp; ++c) {
    if (std::fread(buf.data(), sizeof(double), npts, f) != size_t(npts)) {
      std::fclose(f);
      return -1;
    }
    double* dst = data + int64_t(c) * npts;
    if (dim == 2) {
      const int64_t nx = n[0], ny = n[1];
      for (int64_t j = 0; j < ny; ++j)
        for (int64_t i = 0; i < nx; ++i) dst[i * ny + j] = buf[j * nx + i];
    } else {
      const int64_t nx = n[0], ny = n[1], nz = n[2];
      for (int64_t k = 0; k < nz; ++k)
        for (int64_t j = 0; j < ny; ++j)
          for (int64_t i = 0; i < nx; ++i)
            dst[(i * ny + j) * nz + k] = buf[(k * ny + j) * nx + i];
    }
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"
