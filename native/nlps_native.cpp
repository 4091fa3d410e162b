// nlps_native — C++ runtime components for nlpartsol.
//
// Native equivalents of the reference's host-side C runtime
// (/root/reference/nl-partsol/src/Nodes/Read-GID-Mesh.c:49 parser;
// src/InOutFun/Read_GramsBox.c:57-150 topology build: node→element
// adjacency via get_sourrounding_elements (an O(Nnodes·Nelem) scan there),
// ring-expanded nodal localities, boundary detection, minimum spacing).
// Re-designed as linear-time CSR constructions; exposed through a plain C
// ABI consumed with ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 -o libnlps_native.so
//
// Everything returns malloc'd buffers the caller frees via nlps_free.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cctype>
#include <vector>
#include <unordered_map>
#include <algorithm>
#include <cmath>
#include <array>

extern "C" {

void nlps_free(void *p) { free(p); }

// ---------------------------------------------------------------------------
// GiD ASCII .msh parser
// ---------------------------------------------------------------------------
// Returns 0 on success.  Outputs are malloc'd arrays:
//   coords:  n_nodes * dim doubles (sorted by GiD node id, 0-indexed)
//   conn:    n_elems * nnode int64 (0-indexed node ids)
int nlps_read_gid_mesh(const char *path, int *dim_out, int *nnode_out,
                       int64_t *n_nodes_out, int64_t *n_elems_out,
                       double **coords_out, int64_t **conn_out,
                       char *elem_name_out /* ≥ 32 bytes */) {
  FILE *f = fopen(path, "rb");
  if (!f) return 1;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(sz + 1);
  if (fread(buf.data(), 1, sz, f) != (size_t)sz) { fclose(f); return 2; }
  fclose(f);
  buf[sz] = '\0';

  char *p = buf.data();
  char *end = p + sz;
  int dim = 0, nnode = 0;
  char elem_name[32] = {0};
  std::vector<std::pair<int64_t, std::array<double, 3>>> coords;
  // deferred template issue: use plain struct
  struct Node { int64_t id; double x[3]; };
  std::vector<Node> nodes;
  std::vector<int64_t> conn;
  int mode = 0;  // 0 none, 1 coordinates, 2 elements

  auto skip_ws = [&](char *&q) { while (q < end && (*q == ' ' || *q == '\t' || *q == '\r')) q++; };

  while (p < end) {
    char *line = p;
    char *nl = (char *)memchr(p, '\n', end - p);
    if (!nl) nl = end;
    *nl = '\0';
    p = nl + 1;
    skip_ws(line);
    if (*line == '\0' || *line == '#') continue;

    if (strncasecmp(line, "MESH", 4) == 0) {
      // MESH [name] dimension <d> ElemType <T> Nnode <n>
      char *q = line;
      while (*q) {
        if (strncasecmp(q, "dimension", 9) == 0) dim = (int)strtol(q + 9, &q, 10);
        else if (strncasecmp(q, "ElemType", 8) == 0) {
          q += 8; while (*q == ' ' || *q == '\t') q++;
          int i = 0;
          while (*q && !isspace((unsigned char)*q) && i < 31) elem_name[i++] = *q++;
          elem_name[i] = '\0';
        } else if (strncasecmp(q, "Nnode", 5) == 0) {
          nnode = (int)strtol(q + 5, &q, 10);
        } else q++;
      }
      continue;
    }
    if (strncasecmp(line, "Coordinates", 11) == 0) { mode = 1; continue; }
    if (strncasecmp(line, "End Coordinates", 15) == 0 ||
        strncasecmp(line, "end coordinates", 15) == 0) { mode = 0; continue; }
    if (strncasecmp(line, "Elements", 8) == 0) { mode = 2; continue; }
    if (strncasecmp(line, "End Elements", 12) == 0 ||
        strncasecmp(line, "end elements", 12) == 0) { mode = 0; continue; }

    if (mode == 1) {
      char *q = line;
      Node nd{};
      nd.id = strtoll(q, &q, 10);
      for (int k = 0; k < dim; k++) nd.x[k] = strtod(q, &q);
      nodes.push_back(nd);
    } else if (mode == 2) {
      char *q = line;
      strtoll(q, &q, 10);  // element id (ignored; order preserved)
      for (int k = 0; k < nnode; k++) conn.push_back(strtoll(q, &q, 10) - 1);
    }
  }
  if (dim == 0 || nnode == 0 || nodes.empty()) return 3;

  std::sort(nodes.begin(), nodes.end(),
            [](const Node &a, const Node &b) { return a.id < b.id; });
  int64_t n_nodes = (int64_t)nodes.size();
  int64_t n_elems = (int64_t)conn.size() / nnode;

  double *cx = (double *)malloc(sizeof(double) * n_nodes * dim);
  for (int64_t i = 0; i < n_nodes; i++)
    for (int k = 0; k < dim; k++) cx[i * dim + k] = nodes[i].x[k];
  int64_t *cn = (int64_t *)malloc(sizeof(int64_t) * conn.size());
  memcpy(cn, conn.data(), sizeof(int64_t) * conn.size());

  *dim_out = dim;
  *nnode_out = nnode;
  *n_nodes_out = n_nodes;
  *n_elems_out = n_elems;
  *coords_out = cx;
  *conn_out = cn;
  strncpy(elem_name_out, elem_name, 31);
  return 0;
}

// ---------------------------------------------------------------------------
// Mesh topology: node→element CSR, 1-ring node adjacency CSR, boundary
// nodes (faces owned by exactly one element), minimum node spacing.
// ---------------------------------------------------------------------------
// faces per element type are edges (2D) or quad/tri faces (3D).
static void elem_faces(int nnode, int dim, std::vector<std::vector<int>> &faces) {
  faces.clear();
  if (dim == 2 && nnode == 3) {          // T3 edges
    faces = {{0, 1}, {1, 2}, {2, 0}};
  } else if (dim == 2 && nnode == 4) {   // Q4 edges
    faces = {{0, 1}, {1, 2}, {2, 3}, {3, 0}};
  } else if (dim == 3 && nnode == 4) {   // T4 triangular faces
    faces = {{0, 1, 2}, {0, 1, 3}, {1, 2, 3}, {0, 2, 3}};
  } else if (dim == 3 && nnode == 8) {   // H8 quad faces
    faces = {{0, 1, 2, 3}, {4, 5, 6, 7}, {0, 1, 5, 4},
             {1, 2, 6, 5}, {2, 3, 7, 6}, {3, 0, 4, 7}};
  }
}

int nlps_topology(int64_t n_nodes, int64_t n_elems, int nnode, int dim,
                  const int64_t *conn, const double *coords,
                  // node→element CSR
                  int64_t **ne_off_out, int64_t **ne_idx_out,
                  // 1-ring node→node CSR (nodes sharing an element)
                  int64_t **nn_off_out, int64_t **nn_idx_out,
                  // boundary node flags (0/1), minimum spacing
                  uint8_t **bnd_out, double *min_dx_out) {
  // --- node→element CSR (counting sort; the reference scans
  //     O(Nnodes·Nelems), Read_GramsBox.c:293) ---
  std::vector<int64_t> cnt(n_nodes + 1, 0);
  for (int64_t e = 0; e < n_elems * nnode; e++) cnt[conn[e] + 1]++;
  for (int64_t i = 0; i < n_nodes; i++) cnt[i + 1] += cnt[i];
  int64_t *ne_off = (int64_t *)malloc(sizeof(int64_t) * (n_nodes + 1));
  memcpy(ne_off, cnt.data(), sizeof(int64_t) * (n_nodes + 1));
  int64_t *ne_idx = (int64_t *)malloc(sizeof(int64_t) * n_elems * nnode);
  {
    std::vector<int64_t> cur(cnt.begin(), cnt.end() - 1);
    for (int64_t e = 0; e < n_elems; e++)
      for (int k = 0; k < nnode; k++) ne_idx[cur[conn[e * nnode + k]]++] = e;
  }

  // --- 1-ring node adjacency (dedup per node) ---
  std::vector<int64_t> nn_off_v(n_nodes + 1, 0);
  std::vector<int64_t> nn_idx_v;
  nn_idx_v.reserve(n_elems * nnode * 4);
  {
    std::vector<int64_t> scratch;
    for (int64_t i = 0; i < n_nodes; i++) {
      scratch.clear();
      for (int64_t t = ne_off[i]; t < ne_off[i + 1]; t++) {
        int64_t e = ne_idx[t];
        for (int k = 0; k < nnode; k++) {
          int64_t j = conn[e * nnode + k];
          if (j != i) scratch.push_back(j);
        }
      }
      std::sort(scratch.begin(), scratch.end());
      scratch.erase(std::unique(scratch.begin(), scratch.end()), scratch.end());
      nn_idx_v.insert(nn_idx_v.end(), scratch.begin(), scratch.end());
      nn_off_v[i + 1] = (int64_t)nn_idx_v.size();
    }
  }
  int64_t *nn_off = (int64_t *)malloc(sizeof(int64_t) * (n_nodes + 1));
  memcpy(nn_off, nn_off_v.data(), sizeof(int64_t) * (n_nodes + 1));
  int64_t *nn_idx = (int64_t *)malloc(sizeof(int64_t) * nn_idx_v.size());
  memcpy(nn_idx, nn_idx_v.data(), sizeof(int64_t) * nn_idx_v.size());

  // --- boundary detection: faces referenced by exactly one element ---
  uint8_t *bnd = (uint8_t *)calloc(n_nodes, 1);
  {
    std::vector<std::vector<int>> faces;
    elem_faces(nnode, dim, faces);
    // key: sorted node ids of the face packed into a string key
    std::unordered_map<uint64_t, std::pair<int, std::array<int64_t, 4>>> fmap;
    fmap.reserve(n_elems * faces.size());
    for (int64_t e = 0; e < n_elems; e++) {
      for (auto &fc : faces) {
        std::array<int64_t, 4> ids{-1, -1, -1, -1};
        for (size_t k = 0; k < fc.size(); k++) ids[k] = conn[e * nnode + fc[k]];
        std::array<int64_t, 4> s = ids;
        std::sort(s.begin(), s.begin() + fc.size());
        uint64_t h = 1469598103934665603ull;
        for (size_t k = 0; k < fc.size(); k++) {
          h ^= (uint64_t)s[k] + 0x9e3779b97f4a7c15ull;
          h *= 1099511628211ull;
        }
        auto it = fmap.find(h);
        if (it == fmap.end()) fmap[h] = {1, ids};
        else it->second.first++;
      }
    }
    for (auto &kv : fmap) {
      if (kv.second.first == 1) {
        for (int k = 0; k < 4 && kv.second.second[k] >= 0; k++)
          bnd[kv.second.second[k]] = 1;
      }
    }
  }

  // --- minimum node spacing over element edges (DeltaX,
  //     Read_GramsBox.c / per-element min_DeltaX, T3.c:452) ---
  double min_dx = 1e300;
  {
    std::vector<std::vector<int>> faces;
    elem_faces(nnode, dim, faces);
    for (int64_t e = 0; e < n_elems; e++) {
      for (int a = 0; a < nnode; a++) {
        for (int b = a + 1; b < nnode; b++) {
          int64_t i = conn[e * nnode + a], j = conn[e * nnode + b];
          double d2 = 0;
          for (int k = 0; k < dim; k++) {
            double dd = coords[i * dim + k] - coords[j * dim + k];
            d2 += dd * dd;
          }
          if (d2 > 0 && d2 < min_dx) min_dx = d2;
        }
      }
    }
    min_dx = std::sqrt(min_dx);
  }

  *ne_off_out = ne_off;
  *ne_idx_out = ne_idx;
  *nn_off_out = nn_off;
  *nn_idx_out = nn_idx;
  *bnd_out = bnd;
  *min_dx_out = min_dx;
  return 0;
}

// expand ring-1 adjacency to ring-R localities for one query set
// (fill_nodal_locality / ring_search_nodal_locality, Read_GramsBox.c:57-103)
int nlps_ring_expand(int64_t n_nodes, const int64_t *nn_off,
                     const int64_t *nn_idx, int rings,
                     int64_t **off_out, int64_t **idx_out) {
  std::vector<int64_t> off(n_nodes + 1, 0);
  std::vector<int64_t> out;
  std::vector<int64_t> frontier, next, all;
  std::vector<int8_t> mark(n_nodes, 0);
  std::vector<int64_t> touched;
  for (int64_t i = 0; i < n_nodes; i++) {
    frontier.assign(1, i);
    all.clear();
    mark[i] = 1;
    touched.assign(1, i);
    for (int r = 0; r < rings; r++) {
      next.clear();
      for (int64_t u : frontier) {
        for (int64_t t = nn_off[u]; t < nn_off[u + 1]; t++) {
          int64_t v = nn_idx[t];
          if (!mark[v]) {
            mark[v] = 1;
            touched.push_back(v);
            next.push_back(v);
            all.push_back(v);
          }
        }
      }
      frontier.swap(next);
    }
    std::sort(all.begin(), all.end());
    out.insert(out.end(), all.begin(), all.end());
    off[i + 1] = (int64_t)out.size();
    for (int64_t v : touched) mark[v] = 0;
  }
  int64_t *off_p = (int64_t *)malloc(sizeof(int64_t) * (n_nodes + 1));
  memcpy(off_p, off.data(), sizeof(int64_t) * (n_nodes + 1));
  int64_t *idx_p = (int64_t *)malloc(sizeof(int64_t) * out.size());
  memcpy(idx_p, out.data(), sizeof(int64_t) * out.size());
  *off_out = off_p;
  *idx_out = idx_p;
  return 0;
}

}  // extern "C"
