// Native runtime components for scema_tpu, exposed through a C ABI and
// loaded via ctypes (scema_tpu/native.py).
//
// The reference's runtime-around-the-solver is C++ (deal.II mesh handling,
// VTK writers via deal.II DataOut, the networkx reduction shelled out from
// C++); this rebuild keeps the compute path in XLA but implements the
// IO/runtime pieces natively:
//   * gmsh .msh (v2 ascii) hex-mesh parser        (FE_problem_type.h:94-109)
//   * binary-appended .vtu writer                 (FE_problem.h:2126-2254)
//   * greedy max-degree graph reduction           (coarsegrain_dependency_
//                                                  network.py:59-90)
//
// Build: make -C native   (produces libscema_native.so)

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- msh parse
// Parses $Nodes and hexahedral (type 5) $Elements from a gmsh v2 ascii file.
// Two-phase API: first call msh_parse to load + count, then msh_get_* to
// copy out, then msh_free.

struct MshData {
  std::vector<double> nodes;   // 3*n_nodes
  std::vector<int32_t> cells;  // 8*n_cells (bit-ordered vertices)
};

static const int GMSH_TO_BIT[8] = {0, 1, 3, 2, 4, 5, 7, 6};

void* msh_parse(const char* path, int64_t* n_nodes, int64_t* n_cells) {
  std::ifstream f(path);
  if (!f.good()) return nullptr;
  auto* d = new MshData();
  std::string line;
  std::vector<int64_t> ids;
  std::vector<double> coords;
  std::vector<std::vector<int64_t>> hexes;
  while (std::getline(f, line)) {
    if (line.rfind("$Nodes", 0) == 0) {
      int64_t n;
      f >> n;
      ids.reserve(n);
      coords.reserve(3 * n);
      for (int64_t i = 0; i < n; i++) {
        int64_t id;
        double x, y, z;
        f >> id >> x >> y >> z;
        ids.push_back(id);
        coords.push_back(x);
        coords.push_back(y);
        coords.push_back(z);
      }
    } else if (line.rfind("$Elements", 0) == 0) {
      int64_t n;
      f >> n;
      std::getline(f, line);
      for (int64_t i = 0; i < n; i++) {
        if (!std::getline(f, line)) break;
        std::istringstream ss(line);
        int64_t eid, etype, ntags;
        ss >> eid >> etype >> ntags;
        int64_t tag;
        for (int64_t t = 0; t < ntags; t++) ss >> tag;
        if (etype == 5) {
          std::vector<int64_t> conn(8);
          for (int k = 0; k < 8; k++) ss >> conn[k];
          hexes.push_back(conn);
        }
      }
    }
  }
  if (hexes.empty()) {
    delete d;
    return nullptr;
  }
  // remap ids to dense indices
  std::vector<std::pair<int64_t, int64_t>> order(ids.size());
  for (size_t i = 0; i < ids.size(); i++) order[i] = {ids[i], (int64_t)i};
  std::sort(order.begin(), order.end());
  // id -> dense index via binary search
  auto lookup = [&](int64_t gid) -> int64_t {
    int64_t lo = 0, hi = (int64_t)order.size() - 1;
    while (lo <= hi) {
      int64_t mid = (lo + hi) / 2;
      if (order[mid].first == gid) return mid;
      if (order[mid].first < gid)
        lo = mid + 1;
      else
        hi = mid - 1;
    }
    return -1;
  };
  d->nodes.resize(3 * ids.size());
  for (size_t k = 0; k < order.size(); k++) {
    int64_t src = order[k].second;
    d->nodes[3 * k + 0] = coords[3 * src + 0];
    d->nodes[3 * k + 1] = coords[3 * src + 1];
    d->nodes[3 * k + 2] = coords[3 * src + 2];
  }
  d->cells.resize(8 * hexes.size());
  for (size_t c = 0; c < hexes.size(); c++) {
    for (int k = 0; k < 8; k++) {
      // vertex at bit position k comes from gmsh slot with GMSH_TO_BIT == k
      d->cells[8 * c + GMSH_TO_BIT[k]] = (int32_t)lookup(hexes[c][k]);
    }
  }
  *n_nodes = (int64_t)ids.size();
  *n_cells = (int64_t)hexes.size();
  return d;
}

void msh_get(void* handle, double* nodes_out, int32_t* cells_out) {
  auto* d = (MshData*)handle;
  std::memcpy(nodes_out, d->nodes.data(), d->nodes.size() * sizeof(double));
  std::memcpy(cells_out, d->cells.data(), d->cells.size() * sizeof(int32_t));
}

void msh_free(void* handle) { delete (MshData*)handle; }

// ------------------------------------------------------------- vtu writing
// Binary-appended VTK XML for hex meshes: orders of magnitude smaller and
// faster than the ascii writer for production meshes.

int write_vtu_binary(const char* path, int64_t n_nodes, const double* nodes,
                     int64_t n_cells, const int32_t* cells_bit,
                     int32_t n_point_fields, const char** point_names,
                     const int32_t* point_ncomp, const double** point_data,
                     int32_t n_cell_fields, const char** cell_names,
                     const int32_t* cell_ncomp, const double** cell_data) {
  static const int BIT_TO_VTK[8] = {0, 1, 3, 2, 4, 5, 7, 6};
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  std::string head;
  head += "<?xml version=\"1.0\"?>\n";
  head +=
      "<VTKFile type=\"UnstructuredGrid\" version=\"1.0\" "
      "byte_order=\"LittleEndian\" header_type=\"UInt64\">\n";
  head += "<UnstructuredGrid>\n";
  char buf[512];
  snprintf(buf, sizeof buf,
           "<Piece NumberOfPoints=\"%lld\" NumberOfCells=\"%lld\">\n",
           (long long)n_nodes, (long long)n_cells);
  head += buf;

  uint64_t offset = 0;
  auto data_array = [&](const char* type, const char* name, int ncomp,
                        uint64_t nbytes) {
    char b[512];
    if (name)
      snprintf(b, sizeof b,
               "<DataArray type=\"%s\" Name=\"%s\" NumberOfComponents=\"%d\" "
               "format=\"appended\" offset=\"%llu\"/>\n",
               type, name, ncomp, (unsigned long long)offset);
    else
      snprintf(b, sizeof b,
               "<DataArray type=\"%s\" NumberOfComponents=\"%d\" "
               "format=\"appended\" offset=\"%llu\"/>\n",
               type, ncomp, (unsigned long long)offset);
    head += b;
    offset += 8 + nbytes;
  };

  head += "<Points>\n";
  data_array("Float64", nullptr, 3, 3 * n_nodes * 8);
  head += "</Points>\n<Cells>\n";
  data_array("Int32", "connectivity", 1, 8 * n_cells * 4);
  data_array("Int32", "offsets", 1, n_cells * 4);
  data_array("UInt8", "types", 1, n_cells);
  head += "</Cells>\n<PointData>\n";
  for (int i = 0; i < n_point_fields; i++)
    data_array("Float64", point_names[i], point_ncomp[i],
               (uint64_t)n_nodes * point_ncomp[i] * 8);
  head += "</PointData>\n<CellData>\n";
  for (int i = 0; i < n_cell_fields; i++)
    data_array("Float64", cell_names[i], cell_ncomp[i],
               (uint64_t)n_cells * cell_ncomp[i] * 8);
  head += "</CellData>\n</Piece>\n</UnstructuredGrid>\n";
  head += "<AppendedData encoding=\"raw\">\n_";
  fwrite(head.data(), 1, head.size(), f);

  auto blob = [&](const void* data, uint64_t nbytes) {
    fwrite(&nbytes, 8, 1, f);
    fwrite(data, 1, nbytes, f);
  };

  blob(nodes, 3 * n_nodes * 8);
  std::vector<int32_t> conn(8 * n_cells);
  for (int64_t c = 0; c < n_cells; c++)
    for (int k = 0; k < 8; k++)
      conn[8 * c + k] = cells_bit[8 * c + BIT_TO_VTK[k]];
  blob(conn.data(), conn.size() * 4);
  std::vector<int32_t> offs(n_cells);
  for (int64_t c = 0; c < n_cells; c++) offs[c] = 8 * (c + 1);
  blob(offs.data(), offs.size() * 4);
  std::vector<uint8_t> types(n_cells, 12);
  blob(types.data(), types.size());
  for (int i = 0; i < n_point_fields; i++)
    blob(point_data[i], (uint64_t)n_nodes * point_ncomp[i] * 8);
  for (int i = 0; i < n_cell_fields; i++)
    blob(cell_data[i], (uint64_t)n_cells * cell_ncomp[i] * 8);

  fputs("\n</AppendedData>\n</VTKFile>\n", f);
  fclose(f);
  return 0;
}

// ------------------------------------------------- greedy graph reduction
// adj: n*n row-major 0/1; mapping out: n int32 (identity for isolated
// nodes).  Same algorithm + lowest-id tie-break as clustering/reduction.py.

void reduce_graph(int64_t n, const uint8_t* adj, int32_t* mapping) {
  std::vector<uint8_t> active(n, 0);
  std::vector<int64_t> deg(n, 0);
  for (int64_t i = 0; i < n; i++) {
    mapping[i] = (int32_t)i;
    for (int64_t j = 0; j < n; j++)
      if (adj[i * n + j]) {
        active[i] = 1;
        deg[i]++;
      }
  }
  int64_t n_active = 0;
  for (int64_t i = 0; i < n; i++) n_active += active[i];
  while (n_active > 0) {
    int64_t best = -1, best_deg = -1;
    for (int64_t i = 0; i < n; i++)
      if (active[i] && deg[i] > best_deg) {
        best = i;
        best_deg = deg[i];
      }
    // remove best and its active neighbours
    std::vector<int64_t> removed;
    removed.push_back(best);
    for (int64_t j = 0; j < n; j++)
      if (adj[best * n + j] && active[j]) {
        mapping[j] = (int32_t)best;
        removed.push_back(j);
      }
    for (int64_t r : removed) {
      active[r] = 0;
      n_active--;
    }
    // recompute degrees against remaining active set
    for (int64_t i = 0; i < n; i++) {
      if (!active[i]) continue;
      int64_t d2 = 0;
      for (int64_t j = 0; j < n; j++)
        if (adj[i * n + j] && active[j]) d2++;
      deg[i] = d2;
    }
  }
}

}  // extern "C"
