// Native LCM-UDPM transport: UDP-multicast pub/sub with the LCM datagram
// framing (LC02 short / LC03 fragmented), exposed through a C API consumed
// from Python via ctypes (cafempc/comms/native.py).
//
// This is the performance-critical host-side bridge of the MPC runtime —
// the counterpart of the reference's use of liblcm for the 50 Hz
// state-in / command-out loop (SURVEY §2.6).  Endpoint defaults mirror
// common/utilities.h:303-306 (udpm://239.255.76.67:7667).
//
// Build: make -C native  (produces liblcm_transport.so)

#include <arpa/inet.h>
#include <cstdint>
#include <cstring>
#include <map>
#include <netinet/in.h>
#include <string>
#include <sys/select.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint32_t MAGIC_SHORT = 0x4C433032; // "LC02"
constexpr uint32_t MAGIC_LONG = 0x4C433033;  // "LC03"
constexpr size_t FRAGMENT_SIZE = 60000;

struct FragBuf {
  std::string channel;
  std::vector<uint8_t> data;
  uint32_t received = 0;
  uint16_t expected = 0;
  bool have_channel = false;
};

struct Endpoint {
  int tx_fd = -1;
  int rx_fd = -1;
  sockaddr_in addr{};
  uint32_t seq = 0;
  std::map<std::pair<uint64_t, uint32_t>, FragBuf> frags;
};

void put_u32(uint8_t *p, uint32_t v) {
  p[0] = v >> 24; p[1] = v >> 16; p[2] = v >> 8; p[3] = v;
}
uint32_t get_u32(const uint8_t *p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}
void put_u16(uint8_t *p, uint16_t v) { p[0] = v >> 8; p[1] = v; }
uint16_t get_u16(const uint8_t *p) {
  return (uint16_t(p[0]) << 8) | uint16_t(p[1]);
}

} // namespace

extern "C" {

void *lcmt_create(const char *mcast_ip, int port, int ttl) {
  auto *ep = new Endpoint();
  ep->tx_fd = socket(AF_INET, SOCK_DGRAM, 0);
  ep->rx_fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (ep->tx_fd < 0 || ep->rx_fd < 0) { delete ep; return nullptr; }

  unsigned char ttl_c = (unsigned char)ttl;
  setsockopt(ep->tx_fd, IPPROTO_IP, IP_MULTICAST_TTL, &ttl_c, sizeof(ttl_c));
  unsigned char loop = 1;
  setsockopt(ep->tx_fd, IPPROTO_IP, IP_MULTICAST_LOOP, &loop, sizeof(loop));

  int reuse = 1;
  setsockopt(ep->rx_fd, SOL_SOCKET, SO_REUSEADDR, &reuse, sizeof(reuse));
  int rcvbuf = 8 * 1024 * 1024;  // large bursts of fragments
  setsockopt(ep->rx_fd, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof(rcvbuf));
  sockaddr_in bind_addr{};
  bind_addr.sin_family = AF_INET;
  bind_addr.sin_addr.s_addr = htonl(INADDR_ANY);
  bind_addr.sin_port = htons((uint16_t)port);
  if (bind(ep->rx_fd, (sockaddr *)&bind_addr, sizeof(bind_addr)) < 0) {
    close(ep->tx_fd); close(ep->rx_fd); delete ep; return nullptr;
  }
  ip_mreq mreq{};
  mreq.imr_multiaddr.s_addr = inet_addr(mcast_ip);
  mreq.imr_interface.s_addr = htonl(INADDR_ANY);
  setsockopt(ep->rx_fd, IPPROTO_IP, IP_ADD_MEMBERSHIP, &mreq, sizeof(mreq));

  ep->addr.sin_family = AF_INET;
  ep->addr.sin_addr.s_addr = inet_addr(mcast_ip);
  ep->addr.sin_port = htons((uint16_t)port);
  return ep;
}

int lcmt_publish(void *h, const char *channel, const uint8_t *data,
                 int len) {
  auto *ep = (Endpoint *)h;
  size_t chan_len = strlen(channel) + 1; // incl. nul
  uint32_t seq = ep->seq++;
  if (chan_len + (size_t)len + 8 <= FRAGMENT_SIZE) {
    std::vector<uint8_t> pkt(8 + chan_len + len);
    put_u32(&pkt[0], MAGIC_SHORT);
    put_u32(&pkt[4], seq);
    memcpy(&pkt[8], channel, chan_len);
    memcpy(&pkt[8 + chan_len], data, len);
    ssize_t n = sendto(ep->tx_fd, pkt.data(), pkt.size(), 0,
                       (sockaddr *)&ep->addr, sizeof(ep->addr));
    return n < 0 ? -1 : 0;
  }
  // fragmented
  size_t first_max = FRAGMENT_SIZE - 20 - chan_len;
  std::vector<size_t> sizes;
  sizes.push_back(first_max < (size_t)len ? first_max : (size_t)len);
  size_t off = sizes[0];
  while (off < (size_t)len) {
    size_t s = FRAGMENT_SIZE - 20;
    if (off + s > (size_t)len) s = len - off;
    sizes.push_back(s);
    off += s;
  }
  off = 0;
  for (size_t i = 0; i < sizes.size(); i++) {
    std::vector<uint8_t> pkt(20 + (i == 0 ? chan_len : 0) + sizes[i]);
    put_u32(&pkt[0], MAGIC_LONG);
    put_u32(&pkt[4], seq);
    put_u32(&pkt[8], (uint32_t)len);
    put_u32(&pkt[12], (uint32_t)off);
    put_u16(&pkt[16], (uint16_t)i);
    put_u16(&pkt[18], (uint16_t)sizes.size());
    size_t p = 20;
    if (i == 0) { memcpy(&pkt[p], channel, chan_len); p += chan_len; }
    memcpy(&pkt[p], data + off, sizes[i]);
    if (sendto(ep->tx_fd, pkt.data(), pkt.size(), 0,
               (sockaddr *)&ep->addr, sizeof(ep->addr)) < 0)
      return -1;
    off += sizes[i];
  }
  return 0;
}

// Poll for one complete message.  Returns payload length (>=0) on
// success with channel copied into chan_buf, -1 on timeout/error.
int lcmt_poll(void *h, char *chan_buf, int chan_cap, uint8_t *buf,
              int cap, double timeout_s) {
  auto *ep = (Endpoint *)h;
  timeval deadline{};
  gettimeofday(&deadline, nullptr);
  double t_end = deadline.tv_sec + deadline.tv_usec * 1e-6 + timeout_s;
  for (;;) {
    timeval now{};
    gettimeofday(&now, nullptr);
    double remain = t_end - (now.tv_sec + now.tv_usec * 1e-6);
    if (remain < 0) return -1;
    timeval tv{};
    tv.tv_sec = (time_t)remain;
    tv.tv_usec = (suseconds_t)((remain - tv.tv_sec) * 1e6);
    fd_set rfds;
    FD_ZERO(&rfds);
    FD_SET(ep->rx_fd, &rfds);
    if (select(ep->rx_fd + 1, &rfds, nullptr, nullptr, &tv) <= 0)
      return -1;

    uint8_t pkt[65536];
    sockaddr_in src{};
    socklen_t srclen = sizeof(src);
    ssize_t n = recvfrom(ep->rx_fd, pkt, sizeof(pkt), 0, (sockaddr *)&src,
                         &srclen);
    if (n < 8) continue;
    uint32_t magic = get_u32(pkt);
    if (magic == MAGIC_SHORT) {
      const uint8_t *chan = pkt + 8;
      size_t clen = strnlen((const char *)chan, n - 8);
      if ((int)clen + 1 > chan_cap) continue;
      memcpy(chan_buf, chan, clen + 1);
      int plen = (int)(n - 8 - clen - 1);
      if (plen > cap) continue;
      memcpy(buf, chan + clen + 1, plen);
      return plen;
    }
    if (magic == MAGIC_LONG && n >= 20) {
      uint32_t seq = get_u32(pkt + 4);
      uint32_t msg_sz = get_u32(pkt + 8);
      uint32_t frag_off = get_u32(pkt + 12);
      uint16_t frag_no = get_u16(pkt + 16);
      uint16_t n_frag = get_u16(pkt + 18);
      uint64_t src_key =
          ((uint64_t)src.sin_addr.s_addr << 16) | src.sin_port;
      auto &fb = ep->frags[{src_key, seq}];
      if (fb.data.empty()) {
        fb.data.resize(msg_sz);
        fb.expected = n_frag;
      }
      const uint8_t *body = pkt + 20;
      size_t body_len = n - 20;
      if (frag_no == 0) {
        size_t clen = strnlen((const char *)body, body_len);
        fb.channel.assign((const char *)body, clen);
        fb.have_channel = true;
        body += clen + 1;
        body_len -= clen + 1;
      }
      if (frag_off + body_len <= fb.data.size())
        memcpy(fb.data.data() + frag_off, body, body_len);
      fb.received++;
      if (fb.received == fb.expected && fb.have_channel) {
        if ((int)fb.channel.size() + 1 <= chan_cap &&
            (int)fb.data.size() <= cap) {
          memcpy(chan_buf, fb.channel.c_str(), fb.channel.size() + 1);
          int plen = (int)fb.data.size();
          memcpy(buf, fb.data.data(), plen);
          ep->frags.erase({src_key, seq});
          return plen;
        }
        ep->frags.erase({src_key, seq});
      }
    }
  }
}

void lcmt_destroy(void *h) {
  auto *ep = (Endpoint *)h;
  if (ep) {
    close(ep->tx_fd);
    close(ep->rx_fd);
    delete ep;
  }
}

} // extern "C"
