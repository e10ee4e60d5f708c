// Native runtime codecs for object_detector_6d_tpu (reference parity:
// the reference's IO layer is C++; the device compute path is JAX,
// but store/model loading stays native for production banks).
//
//  * odc_read_store: templates_%s.yml.gz (the oracle FileStorage schema,
//    SURVEY.md section 3.4) -> packed int32 feature/meta tensors.
//    ~2x faster than the pure-Python parser on large banks (both are
//    gzip-bound; the native parser wins on the YAML walk).
//  * odc_load_ply: binary/ascii PLY vertices (+normals) -> float32.
//
// Exposed as a plain C ABI consumed via ctypes (io/native.py); built
// with: g++ -O2 -shared -fPIC odc_native.cpp -lz -o libodc_native.so

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------
// gzip/plain text slurp
// ---------------------------------------------------------------------

static bool read_text(const char* path, std::string& out) {
  size_t n = strlen(path);
  if (n > 3 && strcmp(path + n - 3, ".gz") == 0) {
    gzFile f = gzopen(path, "rb");
    if (!f) return false;
    char buf[1 << 16];
    int got;
    while ((got = gzread(f, buf, sizeof(buf))) > 0) out.append(buf, got);
    gzclose(f);
    return got == 0;
  }
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  char buf[1 << 16];
  size_t got;
  while ((got = fread(buf, 1, sizeof(buf), f)) > 0) out.append(buf, got);
  fclose(f);
  return true;
}

// ---------------------------------------------------------------------
// template store parser (exact subset of the FileStorage YAML schema)
// ---------------------------------------------------------------------

struct Store {
  std::string class_id;
  std::vector<std::string> modalities;
  int pyramid_levels = 0;
  // per template-slot metadata: tid, slot, width, height, pyramid_level
  std::vector<int32_t> meta;
  // features: tid, slot, x, y, label
  std::vector<int32_t> feats;
};

static const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n')) ++p;
  return p;
}

static long parse_int_after(const std::string& text, size_t pos, const char* key) {
  size_t k = text.find(key, pos);
  if (k == std::string::npos) return -1;
  k = text.find(':', k);
  if (k == std::string::npos) return -1;
  return strtol(text.c_str() + k + 1, nullptr, 10);
}

// Parse "- [ x, y, l ]" triplets fast.
static void parse_features(const std::string& text, size_t start, size_t end,
                           int tid, int slot, std::vector<int32_t>& out) {
  const char* p = text.c_str() + start;
  const char* e = text.c_str() + end;
  while (p < e) {
    const char* br = (const char*)memchr(p, '[', e - p);
    if (!br) break;
    const char* body = skip_ws(br + 1, e);
    if (body < e && *body == ']') {  // empty flow list "[]": no feature
      p = body + 1;
      continue;
    }
    char* q;
    long x = strtol(br + 1, &q, 10);
    while (*q == ',' || *q == ' ') ++q;
    long y = strtol(q, &q, 10);
    while (*q == ',' || *q == ' ') ++q;
    long l = strtol(q, &q, 10);
    out.push_back(tid);
    out.push_back(slot);
    out.push_back((int32_t)x);
    out.push_back((int32_t)y);
    out.push_back((int32_t)l);
    p = q;
  }
}

static Store* parse_store(const std::string& text) {
  Store* s = new Store();
  size_t pos = text.find("class_id:");
  if (pos == std::string::npos) { delete s; return nullptr; }
  {
    size_t colon = text.find(':', pos) + 1;
    size_t eol = text.find('\n', colon);
    const char* b = text.c_str() + colon;
    const char* e = text.c_str() + eol;
    b = skip_ws(b, e);
    s->class_id.assign(b, (size_t)(e - b));
    while (!s->class_id.empty() && isspace((unsigned char)s->class_id.back()))
      s->class_id.pop_back();
  }
  {
    size_t m = text.find("modalities:");
    size_t lb = text.find('[', m);
    size_t rb = text.find(']', lb);
    std::string inner = text.substr(lb + 1, rb - lb - 1);
    size_t p = 0;
    while (p < inner.size()) {
      size_t c = inner.find(',', p);
      if (c == std::string::npos) c = inner.size();
      std::string tok = inner.substr(p, c - p);
      size_t a = tok.find_first_not_of(" \t");
      size_t b2 = tok.find_last_not_of(" \t");
      if (a != std::string::npos) s->modalities.push_back(tok.substr(a, b2 - a + 1));
      p = c + 1;
    }
  }
  s->pyramid_levels = (int)parse_int_after(text, 0, "pyramid_levels:");

  // iterate template_pyramids -> template_id blocks -> templates
  size_t tp = text.find("template_pyramids:");
  size_t search = tp;
  while (true) {
    size_t tid_pos = text.find("template_id:", search);
    if (tid_pos == std::string::npos) break;
    long tid = strtol(text.c_str() + tid_pos + 12, nullptr, 10);
    size_t next_tid = text.find("template_id:", tid_pos + 12);
    size_t block_end = next_tid == std::string::npos ? text.size() : next_tid;
    // template slots within the block
    size_t wpos = text.find("width:", tid_pos);
    int slot = 0;
    while (wpos != std::string::npos && wpos < block_end) {
      long w = strtol(text.c_str() + wpos + 6, nullptr, 10);
      long h = parse_int_after(text, wpos, "height:");
      long lvl = parse_int_after(text, wpos, "pyramid_level:");
      size_t fpos = text.find("features:", wpos);
      size_t next_w = text.find("width:", wpos + 6);
      size_t fend = next_w == std::string::npos ? block_end
                    : (next_w < block_end ? next_w : block_end);
      s->meta.push_back((int32_t)tid);
      s->meta.push_back(slot);
      s->meta.push_back((int32_t)w);
      s->meta.push_back((int32_t)h);
      s->meta.push_back((int32_t)lvl);
      if (fpos != std::string::npos && fpos < fend)
        parse_features(text, fpos, fend, (int)tid, slot, s->feats);
      ++slot;
      wpos = next_w;
    }
    search = tid_pos + 12;
  }
  return s;
}

// two-call API: open -> sizes -> fill -> close
void* odc_store_open(const char* path) {
  std::string text;
  if (!read_text(path, text)) return nullptr;
  return parse_store(text);
}

int odc_store_counts(void* handle, int64_t* n_meta, int64_t* n_feats,
                     int* pyramid_levels, int* n_modalities) {
  if (!handle) return -1;
  Store* s = (Store*)handle;
  *n_meta = (int64_t)(s->meta.size() / 5);
  *n_feats = (int64_t)(s->feats.size() / 5);
  *pyramid_levels = s->pyramid_levels;
  *n_modalities = (int)s->modalities.size();
  return 0;
}

int odc_store_fill(void* handle, int32_t* meta, int32_t* feats,
                   char* class_id, int class_id_cap,
                   char* modalities, int modalities_cap) {
  if (!handle) return -1;
  Store* s = (Store*)handle;
  memcpy(meta, s->meta.data(), s->meta.size() * sizeof(int32_t));
  memcpy(feats, s->feats.data(), s->feats.size() * sizeof(int32_t));
  snprintf(class_id, class_id_cap, "%s", s->class_id.c_str());
  std::string mods;
  for (size_t i = 0; i < s->modalities.size(); ++i) {
    if (i) mods += ",";
    mods += s->modalities[i];
  }
  snprintf(modalities, modalities_cap, "%s", mods.c_str());
  return 0;
}

void odc_store_close(void* handle) { delete (Store*)handle; }

// ---------------------------------------------------------------------
// PLY vertex loader (binary_little_endian / ascii; float/double props)
// ---------------------------------------------------------------------

struct Ply {
  std::vector<float> data;  // n x n_cols
  int n_cols = 0;
  int64_t n = 0;
};

void* odc_ply_open(const char* path) {
  std::string text;
  if (!read_text(path, text)) return nullptr;
  size_t he = text.find("end_header\n");
  if (he == std::string::npos) return nullptr;
  size_t body = he + 11;
  bool binary = text.find("binary_little_endian") != std::string::npos;
  bool ascii = text.find("format ascii") != std::string::npos;
  if (!binary && !ascii) return nullptr;

  int64_t n_vertex = 0;
  std::vector<std::pair<std::string, int>> props;  // name, size(4/8/1/2)
  std::vector<char> types;                          // f, d, i (by size)
  {
    size_t p = 0;
    bool in_vertex = false;
    while (p < he) {
      size_t eol = text.find('\n', p);
      std::string line = text.substr(p, eol - p);
      if (line.rfind("element ", 0) == 0) {
        in_vertex = line.find("vertex") != std::string::npos;
        if (in_vertex) n_vertex = strtoll(line.c_str() + line.rfind(' ') + 1, nullptr, 10);
      } else if (in_vertex && line.rfind("property ", 0) == 0) {
        size_t sp1 = line.find(' ');
        size_t sp2 = line.find(' ', sp1 + 1);
        std::string type = line.substr(sp1 + 1, sp2 - sp1 - 1);
        std::string name = line.substr(sp2 + 1);
        int sz = 4;
        char t = 'f';
        if (type == "double" || type == "float64") { sz = 8; t = 'd'; }
        else if (type == "float" || type == "float32") { sz = 4; t = 'f'; }
        else if (type == "uchar" || type == "char" || type == "uint8" || type == "int8") { sz = 1; t = 'i'; }
        else if (type == "short" || type == "ushort") { sz = 2; t = 'i'; }
        else { sz = 4; t = 'i'; }
        props.push_back({name, sz});
        types.push_back(t);
      }
      p = eol + 1;
    }
  }
  // select xyz (+ normals if present)
  int idx[6] = {-1, -1, -1, -1, -1, -1};
  const char* want[6] = {"x", "y", "z", "nx", "ny", "nz"};
  for (size_t i = 0; i < props.size(); ++i)
    for (int w = 0; w < 6; ++w)
      if (props[i].first == want[w]) idx[w] = (int)i;
  int n_cols = (idx[3] >= 0 && idx[4] >= 0 && idx[5] >= 0) ? 6 : 3;
  if (idx[0] < 0 || idx[1] < 0 || idx[2] < 0) return nullptr;

  Ply* out = new Ply();
  out->n_cols = n_cols;
  out->n = n_vertex;
  out->data.resize((size_t)n_vertex * n_cols);

  if (binary) {
    size_t stride = 0;
    std::vector<size_t> offsets(props.size());
    for (size_t i = 0; i < props.size(); ++i) {
      offsets[i] = stride;
      stride += props[i].second;
    }
    const char* base = text.data() + body;
    if (body + stride * (size_t)n_vertex > text.size()) { delete out; return nullptr; }
    for (int64_t v = 0; v < n_vertex; ++v) {
      const char* rec = base + (size_t)v * stride;
      for (int c = 0; c < n_cols; ++c) {
        int pi = idx[c];
        const char* fp = rec + offsets[pi];
        float val;
        if (types[pi] == 'f') { memcpy(&val, fp, 4); }
        else if (types[pi] == 'd') { double d; memcpy(&d, fp, 8); val = (float)d; }
        else { val = 0.0f; }
        out->data[(size_t)v * n_cols + c] = val;
      }
    }
  } else {
    const char* p = text.c_str() + body;
    char* q = const_cast<char*>(p);
    std::vector<double> row(props.size());
    for (int64_t v = 0; v < n_vertex; ++v) {
      for (size_t i = 0; i < props.size(); ++i) row[i] = strtod(q, &q);
      for (int c = 0; c < n_cols; ++c)
        out->data[(size_t)v * n_cols + c] = (float)row[idx[c]];
    }
  }
  return out;
}

int odc_ply_info(void* handle, int64_t* n, int* n_cols) {
  if (!handle) return -1;
  Ply* p = (Ply*)handle;
  *n = p->n;
  *n_cols = p->n_cols;
  return 0;
}

int odc_ply_fill(void* handle, float* out) {
  if (!handle) return -1;
  Ply* p = (Ply*)handle;
  memcpy(out, p->data.data(), p->data.size() * sizeof(float));
  return 0;
}

void odc_ply_close(void* handle) { delete (Ply*)handle; }

}  // extern "C"
