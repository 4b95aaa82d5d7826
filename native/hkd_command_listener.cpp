// C++ consumer demo: subscribe to "mpc_command" over the native LCM-UDPM
// transport and decode hkd_command_lcmt — the role the reference's
// downstream whole-body controller plays when consuming the MPC command
// tape (HKDMPC.cpp:243-298 publishes it; channel names HKDMPC.h:42).
//
// The type hash is recomputed here from the schema spec (lcmgen's struct
// hash), so a successful decode demonstrates wire + schema parity between
// the Python publisher (cafempc/comms/lcm_wire.py) and a native C++
// consumer.
//
// Build: make -C native hkd_command_listener
// Run:   ./native/hkd_command_listener [n_msgs]

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

extern "C" {
void *lcmt_create(const char *mcast_ip, int port, int ttl);
int lcmt_poll(void *h, char *chan_buf, int chan_cap, uint8_t *buf, int cap,
              double timeout_s);
void lcmt_destroy(void *h);
}

namespace {

// ---- lcmgen struct hash (matches comms/lcm_wire.py) -----------------
uint64_t hash_update(uint64_t v, uint8_t c) {
  return ((v << 8) ^ (v >> 55)) + c;
}
uint64_t hash_string(uint64_t v, const std::string &s) {
  v = hash_update(v, (uint8_t)s.size());
  for (char c : s) v = hash_update(v, (uint8_t)c);
  return v;
}

struct FieldSpec {
  const char *name;
  const char *typ;
  std::vector<int> dims; // const dims only (all our schemas)
};

uint64_t type_hash(const std::vector<FieldSpec> &fields) {
  uint64_t v = 0x12345678;
  for (const auto &f : fields) {
    v = hash_string(v, f.name);
    v = hash_string(v, f.typ);
    v = hash_update(v, (uint8_t)f.dims.size());
    for (int d : f.dims) {
      v = hash_update(v, 0); // LCM_CONST
      v = hash_string(v, std::to_string(d));
    }
  }
  return (v << 1) + ((v >> 63) & 1); // rotate (no recursive members)
}

const std::vector<FieldSpec> HKD_COMMAND_FIELDS = {
    {"N_mpcsteps", "int32_t", {}},     {"mpc_times", "double", {10}},
    {"hkd_controls", "float", {10, 24}}, {"des_body_state", "float", {10, 12}},
    {"contacts", "int32_t", {10, 4}},  {"statusTimes", "double", {10, 4}},
    {"foot_placement", "float", {12}}, {"feedback", "float", {10, 12, 12}},
    {"solve_time", "float", {}},
};

// ---- big-endian readers ---------------------------------------------
uint64_t get_u64(const uint8_t *p) {
  uint64_t v = 0;
  for (int i = 0; i < 8; i++) v = (v << 8) | p[i];
  return v;
}
int32_t get_i32(const uint8_t *p) {
  return (int32_t)((uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
                   (uint32_t(p[2]) << 8) | uint32_t(p[3]));
}
float get_f32(const uint8_t *p) {
  uint32_t u = (uint32_t)get_i32(p);
  float f;
  memcpy(&f, &u, 4);
  return f;
}
double get_f64(const uint8_t *p) {
  uint64_t u = get_u64(p);
  double d;
  memcpy(&d, &u, 8);
  return d;
}

} // namespace

int main(int argc, char **argv) {
  int n_msgs = argc > 1 ? atoi(argv[1]) : 5;
  void *ep = lcmt_create("239.255.76.67", 7667, 0);
  if (!ep) {
    fprintf(stderr, "endpoint create failed\n");
    return 1;
  }
  const uint64_t want_hash = type_hash(HKD_COMMAND_FIELDS);
  printf("[c++ listener] hkd_command_lcmt hash %#llx, waiting on "
         "mpc_command...\n",
         (unsigned long long)want_hash);
  fflush(stdout);

  std::vector<uint8_t> buf(1 << 20);
  char chan[256];
  int seen = 0;
  while (seen < n_msgs) {
    int n = lcmt_poll(ep, chan, sizeof(chan), buf.data(), (int)buf.size(),
                      60.0);
    if (n < 0) {
      fprintf(stderr, "[c++ listener] timeout\n");
      lcmt_destroy(ep);
      return 2;
    }
    if (strcmp(chan, "mpc_command") != 0) continue;
    if (n < 8 || get_u64(buf.data()) != want_hash) {
      fprintf(stderr, "[c++ listener] hash mismatch on %s\n", chan);
      lcmt_destroy(ep);
      return 3;
    }
    const uint8_t *p = buf.data() + 8;
    int32_t steps = get_i32(p);
    p += 4;
    double t0 = get_f64(p);            // mpc_times[0]
    p += 8 * 10;
    float u0 = get_f32(p);             // hkd_controls[0][0]
    const uint8_t *pz = p + 10 * 24 * 4 + 4 * 5; // des_body_state[0][5]
    float z_des = get_f32(pz);
    // solve_time is the final field
    float solve_time = get_f32(buf.data() + n - 4);
    printf("[c++ listener] N=%d t0=%.3f u0=%.2f z_des=%.3f solve=%.0fms\n",
           steps, t0, u0, z_des, solve_time * 1e3);
    fflush(stdout);
    seen++;
  }
  lcmt_destroy(ep);
  printf("[c++ listener] ok: %d commands decoded\n", seen);
  return 0;
}
