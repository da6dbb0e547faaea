// Native host-side request encoder: serialized wire batches -> dense
// int32/bool kernel rows, bit-identical to the Python encoder
// (access_control_srv_tpu_torch/ops/encode.py, whose layout is the JAX
// package's).
//
// Host C++ only, no device code: the port's serving path is bounded by
// the per-request Python encode, not by the CUDA kernels it feeds.  This
// library parses the protobuf wire bytes (acstpu.Request,
// proto/access_control.proto) and the JSON context payloads directly and
// fills the numpy row buffers in one pass.  The reference has no native
// code anywhere (SURVEY.md §2); this component exists for the framework's
// own serving throughput.  It is a copy of the JAX package's
// native/host_encoder.cpp with the same semantics.
//
// Semantics transcribed from ops/encode.py (which in turn cites
// reference/src/core/accessController.ts); every eligibility early-exit
// and partial-fill point is replicated in the same order so the
// differential test can require array equality, not just decision
// equality.
//
// Build (native/__init__.py does it on first use, into the port's
// _build/ directory, the file name carrying a hash of this source):
//   g++ -O2 -shared -fPIC -std=c++17 host_encoder.cpp -o libacs_host.so

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <deque>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

constexpr int32_t ABSENT = -1;
// padding caps: runtime parameters of acs_enc_batch (13 int32s in the
// order of ops/encode._CAPS_FLOOR); null means the floor defaults below.
// The serving path encodes at the floor first and re-encodes over-cap
// rows (flagged via the overcap output) at the ceiling shapes, so deep-HR
// traffic stays on the native fast path instead of falling to the oracle.
struct Caps {
  int NR = 4, NI = 4, NP = 8, NSUB = 8, NACT = 4, NOP = 2;
  int NOWN = 4, NRA = 8, NHR = 32, NROLE = 4;
  int NACLE = 4, NACLI = 8, NHRR = 8;
};

// ------------------------------------------------------------- interner

struct Interner {
  // deque: element addresses are stable across growth, so the
  // string_view map keys below stay valid
  std::deque<std::string> strings;
  std::vector<int32_t> suffix_id, tail_id, prefix_id;
  std::unordered_map<std::string_view, int32_t> ids;

  int32_t intern(std::string_view v) {
    auto hit = ids.find(v);
    if (hit != ids.end()) return hit->second;
    int32_t idx = (int32_t)strings.size();
    strings.emplace_back(v);
    // reserve derived slots first (intern below may recurse and grow)
    suffix_id.push_back(ABSENT);
    tail_id.push_back(ABSENT);
    prefix_id.push_back(ABSENT);
    ids.emplace(std::string_view(strings.back()), idx);
    const std::string& s = strings[idx];
    // suffix: after last '#'; tail: after last ':'; prefix: before last ':'
    size_t hash_pos = s.rfind('#');
    std::string suffix = hash_pos == std::string::npos ? s : s.substr(hash_pos + 1);
    size_t colon_pos = s.rfind(':');
    std::string tail = colon_pos == std::string::npos ? s : s.substr(colon_pos + 1);
    std::string prefix = colon_pos == std::string::npos ? std::string() : s.substr(0, colon_pos);
    suffix_id[idx] = suffix == s ? idx : intern(suffix);
    tail_id[idx] = tail == s ? idx : intern(tail);
    prefix_id[idx] = prefix == s ? idx : intern(prefix);
    return idx;
  }
};

// --------------------------------------------------------- JSON parsing
// Minimal JSON DOM sufficient for the context payloads (objects, arrays,
// strings, numbers, true/false/null).  Parse failures yield Null.

struct JValue;
using JArray = std::vector<JValue>;
using JObject = std::vector<std::pair<std::string, JValue>>;

struct JValue {
  enum Kind { Null, Bool, Num, Str, Arr, Obj } kind = Null;
  bool b = false;
  double num = 0;
  std::string str;
  std::vector<JValue> arr;
  std::vector<std::pair<std::string, JValue>> obj;

  const JValue* get(std::string_view key) const {
    // LAST match wins, matching python dict semantics for duplicate JSON
    // keys (json.loads keeps the final occurrence)
    if (kind != Obj) return nullptr;
    const JValue* found = nullptr;
    for (auto& kv : obj)
      if (kv.first == key) found = &kv.second;
    return found;
  }
  bool truthy() const {
    switch (kind) {
      case Null: return false;
      case Bool: return b;
      case Num: return num != 0;
      case Str: return !str.empty();
      case Arr: return !arr.empty();
      case Obj: return !obj.empty();
    }
    return false;
  }
};

struct JsonParser {
  const char* p;
  const char* end;
  bool ok = true;
  int depth = 0;
  // gRPC payloads are attacker-controlled: without a cap, one nested
  // object/array per stack frame overflows the C stack well under the
  // message size limit. Past the cap the row goes ineligible and is served
  // by the (recursion-safe) Python fallback. The cap also bounds JValue
  // destructor recursion, since the DOM can never get deeper than this.
  static constexpr int kMaxDepth = 64;

  explicit JsonParser(std::string_view s) : p(s.data()), end(s.data() + s.size()) {}

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
  }
  bool lit(const char* s, size_t n) {
    if ((size_t)(end - p) < n || memcmp(p, s, n) != 0) return false;
    p += n;
    return true;
  }
  JValue parse() {
    skip_ws();
    JValue v = parse_value();
    skip_ws();
    if (p != end) ok = false;  // trailing garbage: json.loads raises
    return v;
  }
  JValue parse_value() {
    skip_ws();
    JValue v;
    if (p >= end) { ok = false; return v; }
    char c = *p;
    if (c == '{') {
      if (++depth > kMaxDepth) { ok = false; return v; }
      ++p;
      v.kind = JValue::Obj;
      skip_ws();
      if (p < end && *p == '}') { ++p; --depth; return v; }
      while (ok) {
        skip_ws();
        if (p >= end || *p != '"') { ok = false; break; }
        std::string key = parse_string_raw();
        skip_ws();
        if (p >= end || *p != ':') { ok = false; break; }
        ++p;
        v.obj.emplace_back(std::move(key), parse_value());
        skip_ws();
        if (p < end && *p == ',') { ++p; continue; }
        if (p < end && *p == '}') { ++p; break; }
        ok = false;
      }
      --depth;
    } else if (c == '[') {
      if (++depth > kMaxDepth) { ok = false; return v; }
      ++p;
      v.kind = JValue::Arr;
      skip_ws();
      if (p < end && *p == ']') { ++p; --depth; return v; }
      while (ok) {
        v.arr.push_back(parse_value());
        skip_ws();
        if (p < end && *p == ',') { ++p; continue; }
        if (p < end && *p == ']') { ++p; break; }
        ok = false;
      }
      --depth;
    } else if (c == '"') {
      v.kind = JValue::Str;
      v.str = parse_string_raw();
    } else if (c == 't') {
      if (lit("true", 4)) { v.kind = JValue::Bool; v.b = true; } else ok = false;
    } else if (c == 'f') {
      if (lit("false", 5)) { v.kind = JValue::Bool; v.b = false; } else ok = false;
    } else if (c == 'n') {
      if (!lit("null", 4)) ok = false;
    } else {
      // number, RFC 8259 grammar: -?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+-]?[0-9]+)?
      const char* start = p;
      if (p < end && *p == '-') ++p;
      if (p < end && *p == '0') {
        ++p;
      } else if (p < end && *p >= '1' && *p <= '9') {
        while (p < end && *p >= '0' && *p <= '9') ++p;
      } else {
        ok = false;
        return v;
      }
      if (p < end && *p == '.') {
        ++p;
        if (p >= end || *p < '0' || *p > '9') { ok = false; return v; }
        while (p < end && *p >= '0' && *p <= '9') ++p;
      }
      if (p < end && (*p == 'e' || *p == 'E')) {
        ++p;
        if (p < end && (*p == '+' || *p == '-')) ++p;
        if (p >= end || *p < '0' || *p > '9') { ok = false; return v; }
        while (p < end && *p >= '0' && *p <= '9') ++p;
      }
      v.kind = JValue::Num;
      v.num = strtod(std::string(start, p - start).c_str(), nullptr);
    }
    return v;
  }
  std::string parse_string_raw() {
    // assumes *p == '"'. Strict: any input json.loads would reject
    // (unterminated string, unknown or truncated escape, non-hex \uXXXX,
    // raw control character) sets ok=false so the row falls back to the
    // Python path instead of serving a decision computed from a misparse.
    ++p;
    std::string out;
    while (p < end && *p != '"') {
      if (*p == '\\') {
        if (p + 1 >= end) { ok = false; return out; }  // truncated escape
        ++p;
        switch (*p) {
          case '"': out.push_back('"'); break;
          case '\\': out.push_back('\\'); break;
          case '/': out.push_back('/'); break;
          case 'n': out.push_back('\n'); break;
          case 't': out.push_back('\t'); break;
          case 'r': out.push_back('\r'); break;
          case 'b': out.push_back('\b'); break;
          case 'f': out.push_back('\f'); break;
          case 'u': {
            // \uXXXX -> UTF-8 (no surrogate-pair handling; URNs are ASCII)
            if (end - p < 5) { ok = false; return out; }
            unsigned code = 0;
            for (int i = 1; i <= 4; ++i) {
              char h = p[i];
              code <<= 4;
              if (h >= '0' && h <= '9') code |= h - '0';
              else if (h >= 'a' && h <= 'f') code |= h - 'a' + 10;
              else if (h >= 'A' && h <= 'F') code |= h - 'A' + 10;
              else { ok = false; return out; }  // non-hex digit
            }
            p += 4;
            if (code >= 0xD800 && code <= 0xDFFF) {
              // surrogate range: json.loads decodes pairs (and even lone
              // surrogates) with semantics this 3-byte encoder does not
              // reproduce — fall back rather than serve from a misparse
              ok = false;
              return out;
            }
            if (code < 0x80) out.push_back((char)code);
            else if (code < 0x800) {
              out.push_back((char)(0xC0 | (code >> 6)));
              out.push_back((char)(0x80 | (code & 0x3F)));
            } else {
              out.push_back((char)(0xE0 | (code >> 12)));
              out.push_back((char)(0x80 | ((code >> 6) & 0x3F)));
              out.push_back((char)(0x80 | (code & 0x3F)));
            }
            break;
          }
          default: ok = false; return out;  // unknown escape
        }
        ++p;
      } else if ((unsigned char)*p < 0x20) {
        ok = false;  // raw control character: json.loads rejects
        return out;
      } else {
        out.push_back(*p);
        ++p;
      }
    }
    if (p >= end) { ok = false; return out; }  // unterminated string
    ++p;  // closing quote
    return out;
  }
};

// ----------------------------------------------------- protobuf parsing
// Hand-rolled reader for the fixed schema in proto/access_control.proto.

struct PbReader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  PbReader(const uint8_t* data, size_t n) : p(data), end(data + n) {}

  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (p < end && shift < 64) {
      uint8_t b = *p++;
      v |= (uint64_t)(b & 0x7F) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
    }
    ok = false;
    return 0;
  }
  std::string_view len_delim() {
    uint64_t n = varint();
    if (!ok || (uint64_t)(end - p) < n) { ok = false; return {}; }
    std::string_view out((const char*)p, n);
    p += n;
    return out;
  }
  // returns field number, sets wire type; 0 on end
  uint32_t field(uint32_t* wire_type) {
    if (p >= end) return 0;
    uint64_t key = varint();
    if (!ok) return 0;
    *wire_type = key & 7;
    return (uint32_t)(key >> 3);
  }
  void skip(uint32_t wire_type) {
    switch (wire_type) {
      case 0: varint(); break;
      case 1: p += 8; break;
      case 2: len_delim(); break;
      case 5: p += 4; break;
      default: ok = false;
    }
    if (p > end) ok = false;
  }
};

struct Attr {
  std::string_view id;
  std::string_view value;
  std::vector<Attr> attributes;
};

Attr parse_attribute(std::string_view bytes, bool* ok) {
  Attr a;
  PbReader r((const uint8_t*)bytes.data(), bytes.size());
  uint32_t wt;
  while (uint32_t f = r.field(&wt)) {
    if (f == 1 && wt == 2) a.id = r.len_delim();
    else if (f == 2 && wt == 2) a.value = r.len_delim();
    else if (f == 3 && wt == 2)
      a.attributes.push_back(parse_attribute(r.len_delim(), ok));
    else r.skip(wt);
    if (!r.ok) break;
  }
  if (!r.ok) *ok = false;
  return a;
}

struct WireRequest {
  bool parse_ok = true;  // false -> the row must NOT be fabricated into a
                         // 200 decision; it stays on the fallback path
  bool has_target = false;
  bool has_context = false;
  std::vector<Attr> subjects, resources, actions;
  std::string_view subject_json;   // ContextValue.value of context.subject
  bool has_subject = false;
  std::vector<std::string_view> resource_jsons;
};

std::string_view parse_context_value(std::string_view bytes, bool* ok) {
  PbReader r((const uint8_t*)bytes.data(), bytes.size());
  uint32_t wt;
  std::string_view value;
  while (uint32_t f = r.field(&wt)) {
    if (f == 2 && wt == 2) value = r.len_delim();
    else r.skip(wt);
    if (!r.ok) break;
  }
  if (!r.ok) *ok = false;
  return value;
}

WireRequest parse_request(std::string_view bytes) {
  WireRequest req;
  PbReader r((const uint8_t*)bytes.data(), bytes.size());
  uint32_t wt;
  while (uint32_t f = r.field(&wt)) {
    if (f == 1 && wt == 2) {  // Target
      req.has_target = true;
      std::string_view tb = r.len_delim();
      PbReader tr((const uint8_t*)tb.data(), tb.size());
      uint32_t twt;
      while (uint32_t tf = tr.field(&twt)) {
        if (tf == 1 && twt == 2)
          req.subjects.push_back(parse_attribute(tr.len_delim(), &req.parse_ok));
        else if (tf == 2 && twt == 2)
          req.resources.push_back(parse_attribute(tr.len_delim(), &req.parse_ok));
        else if (tf == 3 && twt == 2)
          req.actions.push_back(parse_attribute(tr.len_delim(), &req.parse_ok));
        else tr.skip(twt);
        if (!tr.ok) break;
      }
      if (!tr.ok) req.parse_ok = false;
    } else if (f == 2 && wt == 2) {  // Context
      req.has_context = true;
      std::string_view cb = r.len_delim();
      PbReader cr((const uint8_t*)cb.data(), cb.size());
      uint32_t cwt;
      while (uint32_t cf = cr.field(&cwt)) {
        if (cf == 1 && cwt == 2) {
          req.has_subject = true;
          req.subject_json = parse_context_value(cr.len_delim(), &req.parse_ok);
        } else if (cf == 2 && cwt == 2) {
          req.resource_jsons.push_back(
              parse_context_value(cr.len_delim(), &req.parse_ok));
        } else cr.skip(cwt);
        if (!cr.ok) break;
      }
      if (!cr.ok) req.parse_ok = false;
    } else r.skip(wt);
    if (!r.ok) break;
  }
  if (!r.ok) req.parse_ok = false;
  return req;
}

// ------------------------------------------------------- encoder state

struct Encoder {
  Interner interner;
  // urn ids (into interner): see acs_enc_create for the order
  int32_t urn_entity, urn_property, urn_operation, urn_resource_id;
  int32_t urn_role, urn_scoping, urn_scoping_inst, urn_owner_ent, urn_owner_inst;
  // urn_action_id / crud mirror _URN_ORDER slots 9-13; currently unread
  // (the kernel derives action kind from acl_consts on device)
  int32_t urn_action_id;
  int32_t crud[4];
  int32_t urn_acl_ind, urn_acl_inst;
  bool tails_ambiguous = false;
  std::vector<std::string> vocab_tails;  // tail strings of entity vocab
  // relevance cache keyed by "<tail idx>\x1f<prop value>"
  std::unordered_map<std::string, bool> relevance_ok;
};

struct OutArrays {
  int32_t* r_sub_ids;        // [B, NSUB]
  int32_t* r_sub_vals;       // [B, NSUB]
  int32_t* r_roles;          // [B, NROLE]
  int32_t* r_act_ids;        // [B, NACT]
  int32_t* r_act_vals;       // [B, NACT]
  int32_t* r_ent_vals;       // [B, NR]
  int32_t* r_ent_e;          // [B, NR]
  uint8_t* r_ent_valid;      // [B, NR]
  int32_t* r_inst_run;       // [B, NI]
  int32_t* r_inst_id;        // [B, NI] interned instance-id strings
  uint8_t* r_inst_valid;     // [B, NI]
  uint8_t* r_inst_present;   // [B, NI]
  uint8_t* r_inst_has_owners;// [B, NI]
  int32_t* r_inst_owner_ent; // [B, NI, NOWN]
  int32_t* r_inst_owner_inst;// [B, NI, NOWN]
  int32_t* r_prop_vals;      // [B, NP]
  int32_t* r_prop_sfx;       // [B, NP]
  int32_t* r_prop_run;       // [B, NP]
  int32_t* r_prop_tail;      // [B, NP]
  int32_t* r_op_vals;        // [B, NOP]
  uint8_t* r_op_present;     // [B, NOP]
  uint8_t* r_op_has_owners;  // [B, NOP]
  int32_t* r_op_owner_ent;   // [B, NOP, NOWN]
  int32_t* r_op_owner_inst;  // [B, NOP, NOWN]
  int32_t* r_ra3;            // [B, NRA, 3]
  int32_t* r_ra2;            // [B, NRA, 2]
  int32_t* r_n_ra;           // [B]
  int32_t* r_hr;             // [B, NHR, 2]
  uint8_t* r_ctx_present;    // [B]
  int32_t* r_n_entity_attrs; // [B]
  uint8_t* r_has_props;      // [B]
  uint8_t* r_has_target;     // [B]
  int32_t* r_acl_short;      // [B] 0 pairs / 1 early all-clear / 2 malformed
  int32_t* r_acl_ent;        // [B, NACLE]
  int32_t* r_acl_inst;       // [B, NACLE, NACLI]
  int32_t* r_acl_hr;         // [B, NHR, 2] verifyACL flatten (role, org)
  int32_t* r_hr_roles;       // [B, NHRR] distinct verifyACL-flatten roles
  int32_t* r_subject_id;     // [B]
  uint8_t* eligible;         // [B]
  int32_t* batch_entities;   // [B * NR] distinct entity interner ids out
  uint8_t* overcap;          // [B] ineligible ONLY because a cap overflowed
};

// entity tail: URN segment after the last ':' -- the reference's
// entity_name in the property-relevance check (accessController.ts:515-516).
// Mirrors ops/encode.py:urn_tail and StringInterner.tail_id so r_prop_tail
// compares against the compiled table's t_ent_tails.
std::string entity_tail(const std::string& value) {
  size_t colon = value.rfind(':');
  return colon == std::string::npos ? value : value.substr(colon + 1);
}

const JValue* jget(const JValue* v, std::string_view key) {
  return v == nullptr ? nullptr : v->get(key);
}

std::string_view jstr(const JValue* v) {
  static const std::string empty;
  if (v == nullptr || v->kind != JValue::Str) return std::string_view();
  return v->str;
}

int32_t intern_jstr(Encoder& enc, const JValue* v) {
  if (v == nullptr || v->kind != JValue::Str) return ABSENT;  // intern(None)
  return enc.interner.intern(v->str);
}

// owners -> (entity, instance) pairs; false on NOWN overflow
// (mirrors encode.py:_encode_owners)
bool encode_owners(Encoder& enc, const JValue* owners, int32_t* ent_out,
                   int32_t* inst_out, int NOWN) {
  if (owners == nullptr || owners->kind != JValue::Arr) return true;
  int slot = 0;
  for (const JValue& owner : owners->arr) {
    const JValue* oid = owner.get("id");
    if (jstr(oid) != enc.interner.strings[enc.urn_owner_ent]) continue;
    int32_t val = intern_jstr(enc, owner.get("value"));
    const JValue* attrs = owner.get("attributes");
    if (attrs == nullptr || attrs->kind != JValue::Arr) continue;
    for (const JValue& inst_attr : attrs->arr) {
      if (jstr(inst_attr.get("id")) != enc.interner.strings[enc.urn_owner_inst])
        continue;
      if (slot >= NOWN) return false;
      ent_out[slot] = val;
      inst_out[slot] = intern_jstr(enc, inst_attr.get("value"));
      ++slot;
    }
  }
  return true;
}

// verifyACL's role->org flatten: true pre-order with per-node role
// override (mirrors encode.py:_flatten_acl_hr; reference:
// verifyACL.ts:119-129). Recursion depth is bounded by the JSON parser's
// depth cap. Dedups (role, org) pairs and records distinct non-null role
// keys in first-occurrence order (the create-path scan is order-sensitive).
void flatten_acl_hr(Encoder& enc, const JValue* nodes, bool has_role,
                    std::string_view role_sv,
                    std::vector<std::array<int32_t, 2>>& pairs,
                    std::vector<int32_t>& role_order) {
  if (nodes == nullptr || nodes->kind != JValue::Arr) return;
  for (const JValue& node : nodes->arr) {
    const JValue* role = node.get("role");
    bool node_has_role = has_role;
    std::string_view node_role = role_sv;
    if (role != nullptr && role->kind == JValue::Str) {
      node_has_role = true;
      node_role = role->str;
    }
    std::string_view node_id = jstr(node.get("id"));
    if (!node_id.empty()) {
      // intern ONLY when a pair is appended, role before org — the exact
      // interning order of the Python encoder, so lazily-assigned ids for
      // novel strings stay identical across both encoders
      int32_t rid = node_has_role ? enc.interner.intern(node_role) : ABSENT;
      std::array<int32_t, 2> entry = {rid, enc.interner.intern(node_id)};
      bool seen = false;
      for (auto& existing : pairs) seen |= existing == entry;
      if (!seen) pairs.push_back(entry);
      if (rid != ABSENT) {
        bool have = false;
        for (int32_t r : role_order) have |= r == rid;
        if (!have) role_order.push_back(rid);
      }
    }
    flatten_acl_hr(enc, node.get("children"), node_has_role, node_role,
                   pairs, role_order);
  }
}

// find_ctx_resource: wrapped instance id first, then direct id
// (mirrors core/common.py:find_ctx_resource)
const JValue* find_ctx_resource(const std::vector<JValue>& resources,
                                std::string_view instance_id) {
  for (const JValue& res : resources) {
    const JValue* inst = res.get("instance");
    if (inst != nullptr && jstr(inst->get("id")) == instance_id) return inst;
  }
  for (const JValue& res : resources) {
    if (jstr(res.get("id")) == instance_id) return &res;
  }
  return nullptr;
}

}  // namespace

extern "C" {

// strings: concatenated UTF-8; offs[n+1] boundaries.  urn_ids order:
// [entity, property, operation, resourceID, role, roleScopingEntity,
//  roleScopingInstance, ownerEntity, ownerInstance, actionID,
//  create, read, modify, delete, aclIndicatoryEntity, aclInstance]
// (indices into the preloaded strings)
// vocab_tail_ids: tail interner ids of the entity vocab (W entries).
void* acs_enc_create(const char* strings, const int64_t* offs, int32_t n,
                     const int32_t* urn_ids, int32_t tails_ambiguous,
                     const int32_t* vocab_tail_ids, int32_t W) {
  Encoder* enc = new Encoder();
  for (int32_t i = 0; i < n; ++i) {
    std::string_view s(strings + offs[i], (size_t)(offs[i + 1] - offs[i]));
    int32_t idx = enc->interner.intern(s);
    if (idx != i) {  // preload must reproduce compile-time ids exactly
      delete enc;
      return nullptr;
    }
  }
  enc->urn_entity = urn_ids[0];
  enc->urn_property = urn_ids[1];
  enc->urn_operation = urn_ids[2];
  enc->urn_resource_id = urn_ids[3];
  enc->urn_role = urn_ids[4];
  enc->urn_scoping = urn_ids[5];
  enc->urn_scoping_inst = urn_ids[6];
  enc->urn_owner_ent = urn_ids[7];
  enc->urn_owner_inst = urn_ids[8];
  enc->urn_action_id = urn_ids[9];
  for (int i = 0; i < 4; ++i) enc->crud[i] = urn_ids[10 + i];
  enc->urn_acl_ind = urn_ids[14];
  enc->urn_acl_inst = urn_ids[15];
  enc->tails_ambiguous = tails_ambiguous != 0;
  for (int32_t w = 0; w < W; ++w)
    enc->vocab_tails.push_back(enc->interner.strings[vocab_tail_ids[w]]);
  return enc;
}

void acs_enc_destroy(void* h) { delete (Encoder*)h; }

int32_t acs_enc_n_strings(void* h) {
  return (int32_t)((Encoder*)h)->interner.strings.size();
}

// copy string idx into out (cap bytes); returns its length
int32_t acs_enc_string(void* h, int32_t idx, char* out, int32_t cap) {
  const std::string& s = ((Encoder*)h)->interner.strings[idx];
  int32_t n = (int32_t)s.size();
  if (out != nullptr && cap >= n) memcpy(out, s.data(), n);
  return n;
}

// Encode B serialized acstpu.Request messages (concatenated; offs[B+1]).
// ptrs: the OutArrays fields in declaration order.
// Returns the number of distinct batch entity values (written to
// batch_entities as interner ids), or -1 on a malformed wire input.
int32_t acs_enc_batch(void* h, const uint8_t* buf, const int64_t* offs,
                      int32_t B, void** ptrs, const int32_t* caps) {
  Encoder& enc = *(Encoder*)h;
  Caps C;
  if (caps != nullptr) {
    C.NR = caps[0]; C.NI = caps[1]; C.NP = caps[2]; C.NSUB = caps[3];
    C.NACT = caps[4]; C.NOP = caps[5]; C.NOWN = caps[6]; C.NRA = caps[7];
    C.NHR = caps[8]; C.NROLE = caps[9]; C.NACLE = caps[10];
    C.NACLI = caps[11]; C.NHRR = caps[12];
  }
  const int NR = C.NR, NI = C.NI, NP = C.NP, NSUB = C.NSUB, NACT = C.NACT,
            NOP = C.NOP, NOWN = C.NOWN, NRA = C.NRA, NHR = C.NHR,
            NROLE = C.NROLE, NACLE = C.NACLE, NACLI = C.NACLI,
            NHRR = C.NHRR;
  OutArrays o;
  int pi = 0;
  o.r_sub_ids = (int32_t*)ptrs[pi++];
  o.r_sub_vals = (int32_t*)ptrs[pi++];
  o.r_roles = (int32_t*)ptrs[pi++];
  o.r_act_ids = (int32_t*)ptrs[pi++];
  o.r_act_vals = (int32_t*)ptrs[pi++];
  o.r_ent_vals = (int32_t*)ptrs[pi++];
  o.r_ent_e = (int32_t*)ptrs[pi++];
  o.r_ent_valid = (uint8_t*)ptrs[pi++];
  o.r_inst_run = (int32_t*)ptrs[pi++];
  o.r_inst_id = (int32_t*)ptrs[pi++];
  o.r_inst_valid = (uint8_t*)ptrs[pi++];
  o.r_inst_present = (uint8_t*)ptrs[pi++];
  o.r_inst_has_owners = (uint8_t*)ptrs[pi++];
  o.r_inst_owner_ent = (int32_t*)ptrs[pi++];
  o.r_inst_owner_inst = (int32_t*)ptrs[pi++];
  o.r_prop_vals = (int32_t*)ptrs[pi++];
  o.r_prop_sfx = (int32_t*)ptrs[pi++];
  o.r_prop_run = (int32_t*)ptrs[pi++];
  o.r_prop_tail = (int32_t*)ptrs[pi++];
  o.r_op_vals = (int32_t*)ptrs[pi++];
  o.r_op_present = (uint8_t*)ptrs[pi++];
  o.r_op_has_owners = (uint8_t*)ptrs[pi++];
  o.r_op_owner_ent = (int32_t*)ptrs[pi++];
  o.r_op_owner_inst = (int32_t*)ptrs[pi++];
  o.r_ra3 = (int32_t*)ptrs[pi++];
  o.r_ra2 = (int32_t*)ptrs[pi++];
  o.r_n_ra = (int32_t*)ptrs[pi++];
  o.r_hr = (int32_t*)ptrs[pi++];
  o.r_ctx_present = (uint8_t*)ptrs[pi++];
  o.r_n_entity_attrs = (int32_t*)ptrs[pi++];
  o.r_has_props = (uint8_t*)ptrs[pi++];
  o.r_has_target = (uint8_t*)ptrs[pi++];
  o.r_acl_short = (int32_t*)ptrs[pi++];
  o.r_acl_ent = (int32_t*)ptrs[pi++];
  o.r_acl_inst = (int32_t*)ptrs[pi++];
  o.r_acl_hr = (int32_t*)ptrs[pi++];
  o.r_hr_roles = (int32_t*)ptrs[pi++];
  o.r_subject_id = (int32_t*)ptrs[pi++];
  o.eligible = (uint8_t*)ptrs[pi++];
  o.batch_entities = (int32_t*)ptrs[pi++];
  o.overcap = (uint8_t*)ptrs[pi++];

  std::unordered_map<int32_t, int32_t> batch_entity_idx;
  int32_t n_batch_entities = 0;

  for (int32_t b = 0; b < B; ++b) {
    std::string_view bytes((const char*)(buf + offs[b]),
                           (size_t)(offs[b + 1] - offs[b]));
    WireRequest req = parse_request(bytes);
    if (!req.parse_ok) {
      // malformed wire bytes: never fabricate a decision -- the row falls
      // back to the protobuf path, which surfaces the parse error
      o.eligible[b] = 0;
      continue;
    }

    if (!req.has_target) {  // no-target requests are a host-side 400 DENY
      o.eligible[b] = 0;
      continue;
    }
    o.r_has_target[b] = 1;

    JValue subject;  // Null when absent
    if (req.has_subject && !req.subject_json.empty()) {
      JsonParser jp(req.subject_json);
      subject = jp.parse();
      if (!jp.ok) {
        o.eligible[b] = 0;  // invalid subject JSON -> fallback path
        continue;
      }
    }
    if (subject.get("token") != nullptr && subject.get("token")->truthy()) {
      o.eligible[b] = 0;  // token subjects take the host protocol path
      continue;
    }
    if (subject.kind == JValue::Null) {
      // quirk parity with the Python encoder: a subject-less context can
      // make the reference's unguarded context.subject dereference throw
      // inside verifyACL (verifyACL.ts:112), which the kernel formula
      // cannot represent -- all such rows take the oracle path
      o.eligible[b] = 0;
      continue;
    }

    // ---- subject / roles / actions
    if ((int)req.subjects.size() > NSUB || (int)req.actions.size() > NACT) {
      o.eligible[b] = 0;
      o.overcap[b] = 1;
      continue;
    }
    for (size_t j = 0; j < req.subjects.size(); ++j) {
      o.r_sub_ids[b * NSUB + j] = enc.interner.intern(req.subjects[j].id);
      o.r_sub_vals[b * NSUB + j] = enc.interner.intern(req.subjects[j].value);
    }
    for (size_t j = 0; j < req.actions.size(); ++j) {
      o.r_act_ids[b * NACT + j] = enc.interner.intern(req.actions[j].id);
      o.r_act_vals[b * NACT + j] = enc.interner.intern(req.actions[j].value);
    }

    // distinct roles by STRING, interned only at fill time (after the cap
    // check) -- interning order must match the Python encoder exactly so
    // lazily-assigned ids stay identical across both encoders
    const JValue* role_assocs = subject.get("role_associations");
    std::vector<std::string_view> roles;  // distinct, insertion order
    size_t n_role_assocs = 0;
    if (role_assocs != nullptr && role_assocs->kind == JValue::Arr) {
      n_role_assocs = role_assocs->arr.size();
      for (const JValue& ra : role_assocs->arr) {
        const JValue* role = ra.get("role");
        if (role == nullptr || role->kind != JValue::Str) continue;
        std::string_view rv = role->str;
        bool seen = false;
        for (std::string_view existing : roles) seen |= existing == rv;
        if (!seen) roles.push_back(rv);
      }
    }
    if ((int)roles.size() > NROLE) {
      o.eligible[b] = 0;
      o.overcap[b] = 1;
      continue;
    }
    for (size_t j = 0; j < roles.size(); ++j)
      o.r_roles[b * NROLE + j] = enc.interner.intern(roles[j]);

    // ---- resources: (entity, id*, prop*) runs / operations
    struct Run { std::string_view value; std::vector<std::string_view> instances; };
    std::vector<Run> runs;
    std::vector<std::pair<std::string_view, int>> props;  // (value, run idx)
    std::vector<std::string_view> ops;
    bool ok = true;
    const std::string& s_entity = enc.interner.strings[enc.urn_entity];
    const std::string& s_property = enc.interner.strings[enc.urn_property];
    const std::string& s_operation = enc.interner.strings[enc.urn_operation];
    const std::string& s_resource_id = enc.interner.strings[enc.urn_resource_id];
    for (const Attr& attr : req.resources) {
      if (attr.id == s_entity) {
        runs.push_back({attr.value, {}});
      } else if (attr.id == s_resource_id) {
        if (runs.empty()) continue;  // ids before any entity are ignored
        runs.back().instances.push_back(attr.value);
      } else if (attr.id == s_property) {
        props.emplace_back(attr.value, (int)runs.size() - 1);
      } else if (attr.id == s_operation) {
        ops.push_back(attr.value);
      } else {
        ok = false;  // unknown resource attribute id
        break;
      }
    }
    size_t total_instances = 0;
    for (const Run& run : runs) total_instances += run.instances.size();
    if (!ok) {
      o.eligible[b] = 0;
      continue;
    }
    if ((int)runs.size() > NR || (int)props.size() > NP ||
        (int)ops.size() > NOP || (int)total_instances > NI) {
      o.eligible[b] = 0;
      o.overcap[b] = 1;
      continue;
    }
    if (enc.tails_ambiguous && !props.empty()) {
      o.eligible[b] = 0;
      continue;
    }
    // substring relevance == tail equality for (vocab entity, prop) pairs;
    // cache keyed by the prop STRING (interning here would assign ids
    // earlier than the Python encoder does and break id parity)
    bool relevance_broken = false;
    for (auto& pv : props) {
      std::string value(pv.first);
      bool any_bad = false;
      for (size_t ti = 0; ti < enc.vocab_tails.size(); ++ti) {
        std::string key = std::to_string(ti) + "\x1f" + value;
        auto hit = enc.relevance_ok.find(key);
        bool good;
        if (hit != enc.relevance_ok.end()) {
          good = hit->second;
        } else {
          const std::string& vt = enc.vocab_tails[ti];
          size_t hash_pos = value.find('#');
          std::string prefix =
              hash_pos == std::string::npos ? value : value.substr(0, hash_pos);
          std::string prop_tail = entity_tail(prefix);
          good = (value.find(vt) != std::string::npos) == (vt == prop_tail);
          enc.relevance_ok.emplace(key, good);
        }
        any_bad |= !good;
      }
      if (any_bad) { relevance_broken = true; break; }
    }
    if (relevance_broken) {
      o.eligible[b] = 0;
      continue;
    }

    // ---- context resources (JSON each)
    std::vector<JValue> ctx_resources;
    ctx_resources.reserve(req.resource_jsons.size());
    for (std::string_view rj : req.resource_jsons) {
      if (rj.empty()) {
        ctx_resources.emplace_back();  // Null
      } else {
        JsonParser jp(rj);
        ctx_resources.push_back(jp.parse());
        if (!jp.ok) {
          o.eligible[b] = 0;  // invalid resource JSON -> fallback path
          break;
        }
      }
    }
    if (!o.eligible[b]) continue;

    // ---- ACL pair collection (mirrors encode.py; reference:
    // verifyACL.ts:49-88): walk targeted resource attributes in order; the
    // first one without ACL metadata is the early all-clear, a malformed
    // ACL fails, otherwise (entity -> instances) accumulate
    int32_t acl_short = 0;
    std::vector<int32_t> acl_ents;
    std::vector<std::vector<int32_t>> acl_insts;
    const std::string& s_acl_ind = enc.interner.strings[enc.urn_acl_ind];
    const std::string& s_acl_inst = enc.interner.strings[enc.urn_acl_inst];
    for (const Attr& attr : req.resources) {
      if (attr.id != s_resource_id && attr.id != s_operation) continue;
      const JValue* ctx_res = find_ctx_resource(ctx_resources, attr.value);
      const JValue* acl_list = nullptr;
      if (ctx_res != nullptr) {
        const JValue* acls = jget(ctx_res->get("meta"), "acls");
        if (acls != nullptr && acls->kind == JValue::Arr && !acls->arr.empty())
          acl_list = acls;
      }
      if (acl_list == nullptr) {
        acl_short = 1;  // no ACL metadata: verification passes
        break;
      }
      bool malformed = false;
      for (const JValue& acl : acl_list->arr) {
        if (jstr(acl.get("id")) == s_acl_ind) {
          int32_t ent_id = intern_jstr(enc, acl.get("value"));
          int pos = -1;
          for (size_t e = 0; e < acl_ents.size(); ++e)
            if (acl_ents[e] == ent_id) { pos = (int)e; break; }
          if (pos < 0) {
            pos = (int)acl_ents.size();
            acl_ents.push_back(ent_id);
            acl_insts.emplace_back();
          }
          const JValue* acl_attrs = acl.get("attributes");
          if (acl_attrs == nullptr || acl_attrs->kind != JValue::Arr ||
              acl_attrs->arr.empty()) {
            malformed = true;  // missing ACL instances
            break;
          }
          for (const JValue& attribute : acl_attrs->arr) {
            if (jstr(attribute.get("id")) == s_acl_inst) {
              acl_insts[pos].push_back(
                  intern_jstr(enc, attribute.get("value")));
            } else {
              malformed = true;  // missing ACL instance value
              break;
            }
          }
          if (malformed) break;
        } else {
          malformed = true;  // missing ACL indicatory entity
          break;
        }
      }
      if (malformed) {
        acl_short = 2;
        break;
      }
    }
    if (acl_short == 0) {
      bool over = (int)acl_ents.size() > NACLE;
      for (auto& insts : acl_insts) over |= (int)insts.size() > NACLI;
      // a missing/non-string ACL entity or instance value interns to
      // ABSENT; the kernel's validity masks would silently drop it and
      // pass where the reference fails closed (verifyACL.ts keys its map
      // on undefined) -- fall back to the oracle instead
      bool absent = false;
      for (int32_t e : acl_ents) absent |= e < 0;
      for (auto& insts : acl_insts)
        for (int32_t i : insts) absent |= i < 0;
      if (over || absent) {
        o.eligible[b] = 0;  // ACL shape beyond caps/ABSENT values: fallback
        if (over && !absent) o.overcap[b] = 1;
        continue;
      }
      for (size_t e = 0; e < acl_ents.size(); ++e) {
        o.r_acl_ent[b * NACLE + e] = acl_ents[e];
        for (size_t i = 0; i < acl_insts[e].size(); ++i)
          o.r_acl_inst[(b * NACLE + e) * NACLI + i] = acl_insts[e][i];
      }
    }
    o.r_acl_short[b] = acl_short;
    o.r_subject_id[b] = intern_jstr(enc, subject.get("id"));

    o.r_ctx_present[b] = req.has_context ? 1 : 0;
    o.r_n_entity_attrs[b] = (int32_t)runs.size();
    o.r_has_props[b] = props.empty() ? 0 : 1;

    int inst_slot = 0;
    bool overflow = false;
    for (size_t j = 0; j < runs.size(); ++j) {
      int32_t ent_id = enc.interner.intern(runs[j].value);
      o.r_ent_vals[b * NR + j] = ent_id;
      auto hit = batch_entity_idx.find(ent_id);
      int32_t e;
      if (hit != batch_entity_idx.end()) {
        e = hit->second;
      } else {
        e = n_batch_entities;
        batch_entity_idx.emplace(ent_id, e);
        o.batch_entities[n_batch_entities++] = ent_id;
      }
      o.r_ent_e[b * NR + j] = e;
      o.r_ent_valid[b * NR + j] = 1;
      for (std::string_view inst : runs[j].instances) {
        const JValue* ctx_res = find_ctx_resource(ctx_resources, inst);
        o.r_inst_run[b * NI + inst_slot] = (int32_t)j;
        // interned HERE, matching the Python encoder's fill order (the
        // relation-bit packer keys closure lookups on this id)
        o.r_inst_id[b * NI + inst_slot] = enc.interner.intern(inst);
        o.r_inst_valid[b * NI + inst_slot] = 1;
        if (ctx_res != nullptr) {
          o.r_inst_present[b * NI + inst_slot] = 1;
          const JValue* owners = jget(ctx_res->get("meta"), "owners");
          bool have = owners != nullptr && owners->kind == JValue::Arr &&
                      !owners->arr.empty();
          o.r_inst_has_owners[b * NI + inst_slot] = have ? 1 : 0;
          if (!encode_owners(enc, owners,
                             o.r_inst_owner_ent + (b * NI + inst_slot) * NOWN,
                             o.r_inst_owner_inst + (b * NI + inst_slot) * NOWN,
                             NOWN))
            overflow = true;
        }
        ++inst_slot;
      }
    }
    for (size_t j = 0; j < props.size(); ++j) {
      int32_t vid = enc.interner.intern(props[j].first);
      o.r_prop_vals[b * NP + j] = vid;
      o.r_prop_sfx[b * NP + j] = enc.interner.suffix_id[vid];
      o.r_prop_run[b * NP + j] = props[j].second;
      const std::string& value = enc.interner.strings[vid];
      size_t hash_pos = value.find('#');
      std::string prefix =
          hash_pos == std::string::npos ? value : value.substr(0, hash_pos);
      o.r_prop_tail[b * NP + j] = enc.interner.intern(entity_tail(prefix));
    }
    for (size_t j = 0; j < ops.size(); ++j) {
      o.r_op_vals[b * NOP + j] = enc.interner.intern(ops[j]);
      const JValue* ctx_res = nullptr;
      for (const JValue& res : ctx_resources) {
        if (jstr(res.get("id")) == ops[j]) { ctx_res = &res; break; }
      }
      if (ctx_res != nullptr) {
        o.r_op_present[b * NOP + j] = 1;
        const JValue* owners = jget(ctx_res->get("meta"), "owners");
        bool have = owners != nullptr && owners->kind == JValue::Arr &&
                    !owners->arr.empty();
        o.r_op_has_owners[b * NOP + j] = have ? 1 : 0;
        if (!encode_owners(enc, owners,
                           o.r_op_owner_ent + (b * NOP + j) * NOWN,
                           o.r_op_owner_inst + (b * NOP + j) * NOWN,
                           NOWN))
          overflow = true;
      }
    }

    // ---- role-association triples / pairs + HR closure
    std::vector<std::array<int32_t, 3>> ra3;
    std::vector<std::array<int32_t, 2>> ra2;
    const std::string& s_scoping = enc.interner.strings[enc.urn_scoping];
    const std::string& s_scoping_inst = enc.interner.strings[enc.urn_scoping_inst];
    if (role_assocs != nullptr && role_assocs->kind == JValue::Arr) {
      for (const JValue& ra : role_assocs->arr) {
        int32_t role_id = intern_jstr(enc, ra.get("role"));
        const JValue* attrs = ra.get("attributes");
        if (attrs == nullptr || attrs->kind != JValue::Arr) continue;
        for (const JValue& ra_attr : attrs->arr) {
          if (jstr(ra_attr.get("id")) != s_scoping) continue;
          int32_t ent_id = intern_jstr(enc, ra_attr.get("value"));
          std::array<int32_t, 2> pair = {role_id, ent_id};
          bool seen = false;
          for (auto& existing : ra2) seen |= existing == pair;
          if (!seen) ra2.push_back(pair);
          const JValue* insts = ra_attr.get("attributes");
          if (insts == nullptr || insts->kind != JValue::Arr) continue;
          for (const JValue& inst : insts->arr) {
            if (jstr(inst.get("id")) == s_scoping_inst)
              ra3.push_back({role_id, ent_id, intern_jstr(enc, inst.get("value"))});
          }
        }
      }
    }
    const JValue* hierarchical_scopes = subject.get("hierarchical_scopes");
    bool hs_missing = hierarchical_scopes == nullptr ||
                      hierarchical_scopes->kind == JValue::Null;
    if (hs_missing && n_role_assocs > 0) {
      o.eligible[b] = 0;  // the oracle raises InvalidRequestContext here
      continue;
    }
    // flatten: per top-level subtree, (top role, node id) pairs in
    // stack-DFS order (mirrors encode.py:_flatten_hr)
    std::vector<std::array<int32_t, 2>> hr_enc;
    if (!hs_missing && hierarchical_scopes->kind == JValue::Arr) {
      for (const JValue& top : hierarchical_scopes->arr) {
        int32_t role_id = intern_jstr(enc, top.get("role"));
        std::vector<const JValue*> stack = {&top};
        while (!stack.empty()) {
          const JValue* node = stack.back();
          stack.pop_back();
          std::string_view node_id = jstr(node->get("id"));
          if (!node_id.empty()) {
            std::array<int32_t, 2> entry = {role_id,
                                            enc.interner.intern(node_id)};
            bool seen = false;
            for (auto& existing : hr_enc) seen |= existing == entry;
            if (!seen) hr_enc.push_back(entry);
          }
          const JValue* children = node->get("children");
          if (children != nullptr && children->kind == JValue::Arr)
            for (const JValue& child : children->arr) stack.push_back(&child);
        }
      }
    }
    // verifyACL's own flatten (per-node role override) + its distinct
    // role keys in first-occurrence order (mirrors encode.py)
    std::vector<std::array<int32_t, 2>> acl_hr_enc;
    std::vector<int32_t> hr_roles;
    if (!hs_missing)
      flatten_acl_hr(enc, hierarchical_scopes, false, std::string_view(),
                     acl_hr_enc, hr_roles);
    if ((int)ra3.size() > NRA || (int)ra2.size() > NRA ||
        (int)hr_enc.size() > NHR || (int)acl_hr_enc.size() > NHR ||
        (int)hr_roles.size() > NHRR || overflow) {
      o.eligible[b] = 0;
      o.overcap[b] = 1;
      continue;
    }
    for (size_t j = 0; j < ra3.size(); ++j)
      for (int k = 0; k < 3; ++k) o.r_ra3[(b * NRA + j) * 3 + k] = ra3[j][k];
    for (size_t j = 0; j < ra2.size(); ++j)
      for (int k = 0; k < 2; ++k) o.r_ra2[(b * NRA + j) * 2 + k] = ra2[j][k];
    for (size_t j = 0; j < hr_enc.size(); ++j)
      for (int k = 0; k < 2; ++k) o.r_hr[(b * NHR + j) * 2 + k] = hr_enc[j][k];
    for (size_t j = 0; j < acl_hr_enc.size(); ++j)
      for (int k = 0; k < 2; ++k)
        o.r_acl_hr[(b * NHR + j) * 2 + k] = acl_hr_enc[j][k];
    for (size_t j = 0; j < hr_roles.size(); ++j)
      o.r_hr_roles[b * NHRR + j] = hr_roles[j];
    o.r_n_ra[b] = (int32_t)n_role_assocs;
  }
  return n_batch_entities;
}

// --------------------------------------------------- owner-bit packing
// Native transcription of ops/encode.pack_owner_bitplanes (which once
// deferred to the Python packer): per (row, role-scope-vocab entry) the
// stage-B owner verdicts pack as 2*(nru+NOP) fail bits, laid out exactly
// per ops/encode.owner_bit_layout.  Bit-identity with the Python packer
// is enforced by tests/test_torch_native.py's fuzz comparison; with
// this, the native encode stage runs zero per-row (and zero per-batch)
// Python.

// max over rows of the count of DISTINCT valid instance-bearing runs
// (the Python packer's `counts.max()`; the caller pow2-buckets it to nru)
int32_t acs_own_max_runs(const int32_t* inst_run, const uint8_t* inst_valid,
                         int32_t B, int32_t NI) {
  int32_t max_runs = 0;
  for (int32_t b = 0; b < B; ++b) {
    int32_t distinct = 0;
    // NI is tiny (<= 32): quadratic dedup beats any allocation
    for (int32_t i = 0; i < NI; ++i) {
      if (!inst_valid[b * NI + i]) continue;
      int32_t run = inst_run[b * NI + i];
      if (run < 0) continue;
      bool seen = false;
      for (int32_t j = 0; j < i; ++j)
        seen |= inst_valid[b * NI + j] && inst_run[b * NI + j] == run;
      if (!seen) ++distinct;
    }
    if (distinct > max_runs) max_runs = distinct;
  }
  return max_runs;
}

// own_runs_out: [B, nru] (filled ABSENT-padded, sorted ascending);
// bits_out: [B, nwords] uint32 (fully overwritten) where nwords follows
// owner_bit_layout(RV, nru, NOP).  Raw arrays are the acs_enc_batch
// outputs (or any buffers the Python packer would accept).
void acs_pack_owner_bits(
    const int32_t* inst_run, const uint8_t* inst_valid,
    const uint8_t* inst_present, const uint8_t* inst_has_owners,
    const int32_t* inst_owner_ent, const int32_t* inst_owner_inst,
    const int32_t* op_vals, const uint8_t* op_present,
    const uint8_t* op_has_owners,
    const int32_t* op_owner_ent, const int32_t* op_owner_inst,
    const int32_t* ra3, const int32_t* ra2, const int32_t* hr,
    int32_t B, int32_t NI, int32_t NOWN, int32_t NOP, int32_t NRA,
    int32_t NHR, const int32_t* hrv_role, const int32_t* hrv_scope,
    int32_t RV, int32_t nru, int32_t* own_runs_out, uint32_t* bits_out) {
  const int ebits = 2 * (nru + NOP);
  int epw = 0, wpe = 1, nwords;
  if (ebits <= 32) {
    epw = 32 / ebits;
    nwords = (RV + epw - 1) / epw;
  } else {
    epw = 0;
    wpe = (ebits + 31) / 32;
    nwords = RV * wpe;
  }
  std::vector<int32_t> runs;            // distinct valid runs, ascending
  std::vector<uint8_t> bits(ebits);     // per-entry fail bits, k-indexed
  for (int32_t b = 0; b < B; ++b) {
    const int32_t* b_inst_run = inst_run + b * NI;
    const uint8_t* b_inst_valid = inst_valid + b * NI;
    const int32_t* b_ra3 = ra3 + b * NRA * 3;
    const int32_t* b_ra2 = ra2 + b * NRA * 2;
    const int32_t* b_hr = hr + b * NHR * 2;
    uint32_t* b_words = bits_out + (int64_t)b * nwords;
    for (int w = 0; w < nwords; ++w) b_words[w] = 0;
    int32_t* b_runs = own_runs_out + (int64_t)b * nru;
    for (int g = 0; g < nru; ++g) b_runs[g] = ABSENT;

    runs.clear();
    for (int32_t i = 0; i < NI; ++i) {
      if (!b_inst_valid[i]) continue;
      int32_t run = b_inst_run[i];
      if (run < 0) continue;
      auto it = runs.begin();
      while (it != runs.end() && *it < run) ++it;
      if (it == runs.end() || *it != run) runs.insert(it, run);
    }
    for (size_t g = 0; g < runs.size() && (int)g < nru; ++g)
      b_runs[g] = runs[g];

    for (int32_t e = 0; e < RV; ++e) {
      const int32_t role_e = hrv_role[e];
      const int32_t scope_e = hrv_scope[e];
      // ra2_ok: the (role, scoping entity) pair exists among the valid
      // role-association pairs (mirrors _owner_verdicts' ra2 branch)
      bool ra2_ok = false;
      for (int32_t j = 0; j < NRA; ++j)
        ra2_ok |= b_ra2[j * 2 + 1] >= 0 && b_ra2[j * 2] == role_e &&
                  b_ra2[j * 2 + 1] == scope_e;

      // dir/hier verdict for ONE owner (entity, instance) pair
      auto pair_ok = [&](int32_t qe, int32_t qi, bool* dir, bool* hier) {
        *dir = false;
        *hier = false;
        if (qe != scope_e || qe < 0) return;  // ent_m gate
        for (int32_t j = 0; j < NRA && !*dir; ++j)
          *dir = b_ra3[j * 3 + 1] >= 0 && b_ra3[j * 3] == role_e &&
                 b_ra3[j * 3 + 1] == scope_e && b_ra3[j * 3 + 2] == qi;
        if (ra2_ok)
          for (int32_t j = 0; j < NHR && !*hier; ++j)
            *hier = b_hr[j * 2 + 1] >= 0 && b_hr[j * 2] == role_e &&
                    b_hr[j * 2 + 1] == qi;
      };

      for (int k = 0; k < ebits; ++k) bits[k] = 0;
      for (int32_t i = 0; i < NI; ++i) {
        // valid_i in the Python packer is r_inst_valid & (inst_run >= 0)
        if (!b_inst_valid[i] || b_inst_run[i] < 0) continue;
        bool miss = !(inst_present[b * NI + i] && inst_has_owners[b * NI + i]);
        bool any_dir = false, any_hier = false;
        for (int32_t o = 0; o < NOWN; ++o) {
          bool dir, hier;
          pair_ok(inst_owner_ent[(b * NI + i) * NOWN + o],
                  inst_owner_inst[(b * NI + i) * NOWN + o], &dir, &hier);
          any_dir |= dir;
          any_hier |= hier;
        }
        bool bad_a = miss || !(any_dir || any_hier);
        bool bad_b = miss || !any_dir;
        if (!bad_a && !bad_b) continue;
        // fold into the run group this instance belongs to
        int32_t run = b_inst_run[i];
        for (int g = 0; g < nru; ++g) {
          if (b_runs[g] != run) continue;
          bits[g] |= bad_a ? 1 : 0;
          bits[nru + g] |= bad_b ? 1 : 0;
        }
      }
      for (int32_t j = 0; j < NOP; ++j) {
        if (op_vals[b * NOP + j] < 0) continue;  // op_valid gate
        bool miss = !(op_present[b * NOP + j] && op_has_owners[b * NOP + j]);
        bool any_dir = false, any_hier = false;
        for (int32_t o = 0; o < NOWN; ++o) {
          bool dir, hier;
          pair_ok(op_owner_ent[(b * NOP + j) * NOWN + o],
                  op_owner_inst[(b * NOP + j) * NOWN + o], &dir, &hier);
          any_dir |= dir;
          any_hier |= hier;
        }
        bits[2 * nru + j] |= (miss || !(any_dir || any_hier)) ? 1 : 0;
        bits[2 * nru + NOP + j] |= (miss || !any_dir) ? 1 : 0;
      }

      // pack entry e's bits per owner_bit_layout
      if (epw) {
        uint32_t* word = b_words + e / epw;
        int base = (e % epw) * ebits;
        for (int k = 0; k < ebits; ++k)
          if (bits[k]) *word |= 1u << (base + k);
      } else {
        for (int k = 0; k < ebits; ++k)
          if (bits[k]) b_words[e * wpe + k / 32] |= 1u << (k % 32);
      }
    }
  }
}

// intern (or look up) one string in THIS encoder's id space.  The
// serving store translates its relation verdict tables into native ids
// with this (srv/relations.tables_for(space="native")) — strings interned
// after the preload snapshot diverge between the Python and C++ spaces,
// so each id space gets its own table build.  Caller holds the
// per-encoder call lock (the interner is not thread-safe).
int32_t acs_enc_intern(void* h, const char* bytes, int32_t len) {
  return ((Encoder*)h)->interner.intern(
      std::string_view(bytes, (size_t)len));
}

// ------------------------------------------------- relation-bit packing
// Native transcription of ops/relation.pack_relation_bitplanes: per
// (row, relation-vocab entry) the reachable-subject verdicts of the
// targeted instances fold into packed A/B fail bits laid out by
// ops/encode.owner_bit_layout(RELV, nru, 0) (ebits = 2*nru; bit g =
// full-closure plane fails for run g, bit nru+g = literal-tuples plane
// fails).  Membership comes from the store's flat verdict tables
// (translated into this encoder's id space): segment [obj_offs[v*2+p],
// obj_offs[v*2+p+1]) of sorted (ent<<32)|inst object keys, plus one
// globally sorted (object_row<<32)|subject pairs array — two binary
// searches per (instance, vocab, plane).  Bit-identity with the Python
// packer is enforced by tests/test_torch_native.py's fuzz comparison.
void acs_pack_relation_bits(
    const int32_t* inst_run, const uint8_t* inst_valid,
    const int32_t* ent_vals, const int32_t* inst_id,
    const int32_t* subject_id,
    int32_t B, int32_t NR, int32_t NI,
    const int64_t* obj_offs, const int64_t* obj_keys,
    const int64_t* pairs, int64_t n_pairs,
    int32_t RELV, int32_t nru,
    int32_t* rel_runs_out, uint32_t* bits_out) {
  const int ebits = 2 * nru;
  int epw = 0, wpe = 1, nwords;
  if (ebits <= 32) {
    epw = 32 / ebits;
    nwords = (RELV + epw - 1) / epw;
  } else {
    wpe = (ebits + 31) / 32;
    nwords = RELV * wpe;
  }
  // verdict for one (vocab, plane) segment: object-key search, then the
  // (GLOBAL object row, subject) pair search — mirrors _plane_pass
  auto plane_pass = [&](int32_t idx, int64_t key, int64_t subj) -> bool {
    int64_t lo = obj_offs[idx], hi = obj_offs[idx + 1];
    if (hi <= lo || n_pairs == 0) return false;
    const int64_t* it = std::lower_bound(obj_keys + lo, obj_keys + hi, key);
    if (it == obj_keys + hi || *it != key) return false;
    int64_t pk = ((int64_t)(it - obj_keys) << 32) | subj;
    const int64_t* pit = std::lower_bound(pairs, pairs + n_pairs, pk);
    return pit != pairs + n_pairs && *pit == pk;
  };
  std::vector<int32_t> runs;         // distinct valid runs, ascending
  std::vector<uint8_t> bits(ebits);  // per-entry fail bits, k-indexed
  for (int32_t b = 0; b < B; ++b) {
    const int32_t* b_inst_run = inst_run + (int64_t)b * NI;
    const uint8_t* b_inst_valid = inst_valid + (int64_t)b * NI;
    uint32_t* b_words = bits_out + (int64_t)b * nwords;
    for (int w = 0; w < nwords; ++w) b_words[w] = 0;
    int32_t* b_runs = rel_runs_out + (int64_t)b * nru;
    for (int g = 0; g < nru; ++g) b_runs[g] = ABSENT;

    runs.clear();
    for (int32_t i = 0; i < NI; ++i) {
      if (!b_inst_valid[i]) continue;
      int32_t run = b_inst_run[i];
      if (run < 0) continue;
      auto it = runs.begin();
      while (it != runs.end() && *it < run) ++it;
      if (it == runs.end() || *it != run) runs.insert(it, run);
    }
    for (size_t g = 0; g < runs.size() && (int)g < nru; ++g)
      b_runs[g] = runs[g];

    const bool subj_ok = subject_id[b] >= 0;
    const int64_t subj_pk = subj_ok ? (int64_t)subject_id[b] : 0;
    for (int32_t v = 0; v < RELV; ++v) {
      for (int k = 0; k < ebits; ++k) bits[k] = 0;
      for (int32_t i = 0; i < NI; ++i) {
        // valid_i in the Python packer: r_inst_valid & (inst_run >= 0)
        if (!b_inst_valid[i] || b_inst_run[i] < 0) continue;
        int32_t run = b_inst_run[i];
        int32_t ent = ent_vals[(int64_t)b * NR + run];
        int32_t inst = inst_id[(int64_t)b * NI + i];
        bool key_ok = ent >= 0 && inst >= 0 && subj_ok;
        int64_t key = ((int64_t)(ent < 0 ? 0 : ent) << 32)
                      | (int64_t)(inst < 0 ? 0 : inst);
        bool ok_f = key_ok && plane_pass(v * 2, key, subj_pk);
        bool ok_d = key_ok && plane_pass(v * 2 + 1, key, subj_pk);
        if (ok_f && ok_d) continue;
        for (int g = 0; g < nru; ++g) {
          if (b_runs[g] != run) continue;
          if (!ok_f) bits[g] = 1;
          if (!ok_d) bits[nru + g] = 1;
        }
      }
      // pack entry v's bits per owner_bit_layout(RELV, nru, 0)
      if (epw) {
        uint32_t* word = b_words + v / epw;
        int base = (v % epw) * ebits;
        for (int k = 0; k < ebits; ++k)
          if (bits[k]) *word |= 1u << (base + k);
      } else {
        for (int k = 0; k < ebits; ++k)
          if (bits[k]) b_words[v * wpe + k / 32] |= 1u << (k % 32);
      }
    }
  }
}

}  // extern "C"
