/* Native USIG implementation.  See usig.h for the contract and the
 * reference-parity notes (reference usig/sgx/enclave/usig.c semantics:
 * sign {digest, epoch, counter}, increment-after-sign, counters from 1,
 * seal/unseal round-trip).
 */

#include "usig.h"

#include <cstring>
#include <mutex>
#include <new>
#include <vector>

#include "ossl.h"

namespace {

/* Seal layout v2: magic(4) || der-private-key.  The epoch is NOT sealed:
 * every init draws a fresh random epoch (reference usig.c:168-186 draws
 * sgx_read_rand before unsealing), so a restored instance whose counter
 * restarts at 1 can never re-certify (epoch, cv) pairs already issued by
 * a previous instance of the same key. */
constexpr unsigned char kSealMagic[4] = {'U', 'S', 'G', '2'};
/* v1 blobs carried a sealed epoch (magic || epoch_be8 || key); accepted
 * for key recovery, with the stored epoch ignored. */
constexpr unsigned char kSealMagicV1[4] = {'U', 'S', 'G', '1'};
/* v3: encrypted-at-rest (the sgx_seal_data confidentiality analogue,
 * reference usig.c:107-116).  Layout:
 *   magic(4) || salt(16) || iters_be4 || nonce(12) || ct || tag(16)
 * with key = PBKDF2-HMAC-SHA256(secret, salt, iters, 32) and
 * AES-256-GCM over the DER private key. */
constexpr unsigned char kSealMagicV3[4] = {'U', 'S', 'G', '3'};
constexpr size_t kSaltLen = 16;
constexpr size_t kNonceLen = 12;
constexpr size_t kTagLen = 16;
constexpr uint32_t kKdfIters = 60000;
constexpr size_t kV3Overhead = 4 + kSaltLen + 4 + kNonceLen + kTagLen;

bool kdf_key(const uint8_t *secret, size_t secret_len,
             const unsigned char *salt, uint32_t iters,
             unsigned char out[32]) {
  return PKCS5_PBKDF2_HMAC(reinterpret_cast<const char *>(secret),
                           static_cast<int>(secret_len), salt,
                           static_cast<int>(kSaltLen),
                           static_cast<int>(iters), EVP_sha256(), 32,
                           out) == 1;
}

/* AES-256-GCM one-shot encrypt: ct || tag appended at out. */
bool gcm_encrypt(const unsigned char key[32], const unsigned char *nonce,
                 const unsigned char *plain, int plain_len,
                 unsigned char *ct_out, unsigned char *tag_out) {
  EVP_CIPHER_CTX *ctx = EVP_CIPHER_CTX_new();
  if (ctx == nullptr) return false;
  int len = 0, ok = 0;
  ok = EVP_EncryptInit_ex(ctx, EVP_aes_256_gcm(), nullptr, nullptr, nullptr) == 1 &&
       EVP_CIPHER_CTX_ctrl(ctx, EVP_CTRL_GCM_SET_IVLEN,
                           static_cast<int>(kNonceLen), nullptr) == 1 &&
       EVP_EncryptInit_ex(ctx, nullptr, nullptr, key, nonce) == 1 &&
       EVP_EncryptUpdate(ctx, ct_out, &len, plain, plain_len) == 1 &&
       len == plain_len &&
       EVP_EncryptFinal_ex(ctx, ct_out + len, &len) == 1 &&
       EVP_CIPHER_CTX_ctrl(ctx, EVP_CTRL_GCM_GET_TAG,
                           static_cast<int>(kTagLen), tag_out) == 1;
  EVP_CIPHER_CTX_free(ctx);
  return ok;
}

bool gcm_decrypt(const unsigned char key[32], const unsigned char *nonce,
                 const unsigned char *ct, int ct_len,
                 const unsigned char *tag, unsigned char *plain_out) {
  EVP_CIPHER_CTX *ctx = EVP_CIPHER_CTX_new();
  if (ctx == nullptr) return false;
  int len = 0, ok = 0;
  unsigned char tagbuf[kTagLen];
  std::memcpy(tagbuf, tag, kTagLen);
  ok = EVP_DecryptInit_ex(ctx, EVP_aes_256_gcm(), nullptr, nullptr, nullptr) == 1 &&
       EVP_CIPHER_CTX_ctrl(ctx, EVP_CTRL_GCM_SET_IVLEN,
                           static_cast<int>(kNonceLen), nullptr) == 1 &&
       EVP_DecryptInit_ex(ctx, nullptr, nullptr, key, nonce) == 1 &&
       EVP_DecryptUpdate(ctx, plain_out, &len, ct, ct_len) == 1 &&
       len == ct_len &&
       EVP_CIPHER_CTX_ctrl(ctx, EVP_CTRL_GCM_SET_TAG,
                           static_cast<int>(kTagLen), tagbuf) == 1 &&
       EVP_DecryptFinal_ex(ctx, plain_out + len, &len) == 1;
  EVP_CIPHER_CTX_free(ctx);
  return ok;
}

/* DER ECDSA-Sig-Value -> raw r||s (32+32 big-endian).  The encoding is
 * SEQUENCE { INTEGER r, INTEGER s } with minimal-length integers. */
bool der_to_raw64(const unsigned char *der, size_t len, unsigned char out[64]) {
  size_t off = 0;
  auto read_hdr = [&](unsigned char want_tag, size_t *out_len) -> bool {
    if (off + 2 > len || der[off] != want_tag) return false;
    ++off;
    size_t l = der[off++];
    if (l & 0x80) {
      size_t nbytes = l & 0x7f;
      if (nbytes == 0 || nbytes > 2 || off + nbytes > len) return false;
      l = 0;
      for (size_t i = 0; i < nbytes; ++i) l = (l << 8) | der[off++];
    }
    if (off + l > len) return false;
    *out_len = l;
    return true;
  };
  size_t seq_len;
  if (!read_hdr(0x30, &seq_len)) return false;
  std::memset(out, 0, 64);
  for (int part = 0; part < 2; ++part) {
    size_t int_len;
    if (!read_hdr(0x02, &int_len)) return false;
    const unsigned char *p = der + off;
    off += int_len;
    /* strip leading zero pad */
    while (int_len > 0 && p[0] == 0x00) {
      ++p;
      --int_len;
    }
    if (int_len > 32) return false;
    std::memcpy(out + part * 32 + (32 - int_len), p, int_len);
  }
  return off == len;
}

/* raw r||s -> DER (for verification through OpenSSL). */
std::vector<unsigned char> raw64_to_der(const unsigned char sig[64]) {
  auto encode_int = [](const unsigned char *p) {
    std::vector<unsigned char> v;
    size_t n = 32;
    while (n > 1 && p[32 - n] == 0x00) --n;
    const unsigned char *q = p + (32 - n);
    v.push_back(0x02);
    if (q[0] & 0x80) {
      v.push_back(static_cast<unsigned char>(n + 1));
      v.push_back(0x00);
    } else {
      v.push_back(static_cast<unsigned char>(n));
    }
    v.insert(v.end(), q, q + n);
    return v;
  };
  std::vector<unsigned char> r = encode_int(sig);
  std::vector<unsigned char> s = encode_int(sig + 32);
  std::vector<unsigned char> der;
  der.push_back(0x30);
  der.push_back(static_cast<unsigned char>(r.size() + s.size()));
  der.insert(der.end(), r.begin(), r.end());
  der.insert(der.end(), s.begin(), s.end());
  return der;
}

bool sha256(const void *data, size_t len, unsigned char out[32]) {
  unsigned int sz = 0;
  return EVP_Digest(data, len, out, &sz, EVP_sha256(), nullptr) == 1 &&
         sz == 32;
}

/* SHA256(digest32 || epoch_be8 || counter_be8) — must match
 * usig/software.py _signed_payload. */
bool signed_payload(const unsigned char digest[32], uint64_t epoch,
                    uint64_t counter, unsigned char out[32]) {
  unsigned char buf[48];
  std::memcpy(buf, digest, 32);
  for (int i = 0; i < 8; ++i)
    buf[32 + i] = static_cast<unsigned char>(epoch >> (56 - 8 * i));
  for (int i = 0; i < 8; ++i)
    buf[40 + i] = static_cast<unsigned char>(counter >> (56 - 8 * i));
  return sha256(buf, sizeof buf, out);
}

}  // namespace

struct usig {
  EVP_PKEY *key = nullptr;
  uint64_t epoch = 0;    /* random per instance (usig.c:181) */
  uint64_t counter = 1;  /* counters start at 1 */
  std::mutex mu;         /* reference ecallLock analogue */
};

extern "C" {

const char *usig_native_version(void) { return "minbft-tpu-usig/1 openssl3"; }

int usig_init(usig_t **out, const uint8_t *sealed, size_t sealed_len) {
  return usig_init2(out, sealed, sealed_len, nullptr, 0);
}

int usig_init2(usig_t **out, const uint8_t *sealed, size_t sealed_len,
               const uint8_t *secret, size_t secret_len) {
  if (out == nullptr) return USIG_ERR_ARG;
  usig_t *u = new (std::nothrow) usig_t;
  if (u == nullptr) return USIG_ERR_ALLOC;
  /* Fresh random epoch on EVERY init — including restores.  The counter
   * restarts at 1, so reusing an old epoch would let a restarted instance
   * certify different messages under already-issued (epoch, cv) values:
   * exactly the equivocation USIG exists to prevent (reference
   * usig.c:177-186).  Verifiers learn the new epoch trust-on-first-use
   * (reference crypto.go:204-218; SampleAuthenticator epoch capture). */
  unsigned char eb[8];
  if (RAND_bytes(eb, 8) != 1) {
    delete u;
    return USIG_ERR_CRYPTO;
  }
  u->epoch = 0;
  for (int i = 0; i < 8; ++i) u->epoch = (u->epoch << 8) | eb[i];
  if (sealed == nullptr) {
    u->key = EVP_PKEY_Q_keygen(nullptr, nullptr, "EC", "P-256");
    if (u->key == nullptr) {
      delete u;
      return USIG_ERR_CRYPTO;
    }
  } else if (sealed_len > kV3Overhead &&
             std::memcmp(sealed, kSealMagicV3, 4) == 0) {
    /* v3: AES-256-GCM under the operator secret. */
    if (secret == nullptr || secret_len == 0) {
      delete u;
      return USIG_ERR_SECRET;
    }
    const unsigned char *salt = sealed + 4;
    uint32_t iters = 0;
    for (int i = 0; i < 4; ++i)
      iters = (iters << 8) | sealed[4 + kSaltLen + i];
    if (iters == 0 || iters > 10u * 1000u * 1000u) {
      delete u;
      return USIG_ERR_SEALED;
    }
    const unsigned char *nonce = sealed + 4 + kSaltLen + 4;
    const unsigned char *ct = nonce + kNonceLen;
    size_t ct_len = sealed_len - kV3Overhead;
    const unsigned char *tag = ct + ct_len;
    unsigned char key[32];
    std::vector<unsigned char> plain(ct_len);
    if (!kdf_key(secret, secret_len, salt, iters, key)) {
      delete u;
      return USIG_ERR_CRYPTO;
    }
    if (!gcm_decrypt(key, nonce, ct, static_cast<int>(ct_len), tag,
                     plain.data())) {
      /* GCM wrote (garbage or partially correct) plaintext before the
       * tag check failed — scrub it like the success path does. */
      std::memset(plain.data(), 0, plain.size());
      std::memset(key, 0, sizeof key);
      delete u;
      return USIG_ERR_SECRET;
    }
    std::memset(key, 0, sizeof key);
    const unsigned char *p = plain.data();
    u->key = d2i_AutoPrivateKey(nullptr, &p, static_cast<long>(ct_len));
    std::memset(plain.data(), 0, plain.size());
    if (u->key == nullptr) {
      delete u;
      return USIG_ERR_SEALED;
    }
  } else {
    size_t key_off;
    if (sealed_len >= 5 && std::memcmp(sealed, kSealMagic, 4) == 0) {
      key_off = 4;
    } else if (sealed_len >= 13 &&
               std::memcmp(sealed, kSealMagicV1, 4) == 0) {
      key_off = 12; /* skip the v1 sealed epoch; it is never reused */
    } else {
      delete u;
      return USIG_ERR_SEALED;
    }
    const unsigned char *p = sealed + key_off;
    u->key = d2i_AutoPrivateKey(nullptr, &p,
                                static_cast<long>(sealed_len - key_off));
    if (u->key == nullptr) {
      delete u;
      return USIG_ERR_SEALED;
    }
  }
  *out = u;
  return USIG_OK;
}

int usig_destroy(usig_t *u) {
  if (u == nullptr) return USIG_ERR_ARG;
  EVP_PKEY_free(u->key);
  delete u;
  return USIG_OK;
}

int usig_get_epoch(usig_t *u, uint64_t *epoch) {
  if (u == nullptr || epoch == nullptr) return USIG_ERR_ARG;
  *epoch = u->epoch;
  return USIG_OK;
}

int usig_get_pubkey(usig_t *u, uint8_t out[64]) {
  if (u == nullptr || out == nullptr) return USIG_ERR_ARG;
  unsigned char pt[65];
  size_t sz = 0;
  if (EVP_PKEY_get_octet_string_param(u->key, "pub", pt, sizeof pt, &sz) != 1 ||
      sz != 65 || pt[0] != 0x04)
    return USIG_ERR_CRYPTO;
  std::memcpy(out, pt + 1, 64);
  return USIG_OK;
}

int usig_create_ui(usig_t *u, const uint8_t digest[32], uint64_t *counter,
                   uint8_t sig_out[64]) {
  if (u == nullptr || digest == nullptr || counter == nullptr ||
      sig_out == nullptr)
    return USIG_ERR_ARG;
  std::lock_guard<std::mutex> lock(u->mu);
  unsigned char payload[32];
  if (!signed_payload(digest, u->epoch, u->counter, payload))
    return USIG_ERR_CRYPTO;
  EVP_PKEY_CTX *ctx = EVP_PKEY_CTX_new(u->key, nullptr);
  if (ctx == nullptr) return USIG_ERR_CRYPTO;
  unsigned char der[80];
  size_t der_len = sizeof der;
  int ok = EVP_PKEY_sign_init(ctx) == 1 &&
           EVP_PKEY_sign(ctx, der, &der_len, payload, 32) == 1;
  EVP_PKEY_CTX_free(ctx);
  if (!ok || !der_to_raw64(der, der_len, sig_out)) return USIG_ERR_CRYPTO;
  *counter = u->counter;
  /* Increment only after the signature exists: this counter value can
   * never be issued again (reference usig.c:66-69). */
  u->counter += 1;
  return USIG_OK;
}

int usig_sealed_size(usig_t *u, size_t *out) {
  if (u == nullptr || out == nullptr) return USIG_ERR_ARG;
  int der_len = i2d_PrivateKey(u->key, nullptr);
  if (der_len <= 0) return USIG_ERR_CRYPTO;
  *out = 4 + static_cast<size_t>(der_len);
  return USIG_OK;
}

int usig_seal(usig_t *u, uint8_t *out, size_t cap, size_t *out_len) {
  if (u == nullptr || out == nullptr || out_len == nullptr)
    return USIG_ERR_ARG;
  size_t need = 0;
  int rc = usig_sealed_size(u, &need);
  if (rc != USIG_OK) return rc;
  if (cap < need) return USIG_ERR_BUFSZ;
  std::memcpy(out, kSealMagic, 4);
  unsigned char *p = out + 4;
  int der_len = i2d_PrivateKey(u->key, &p);
  if (der_len <= 0) return USIG_ERR_CRYPTO;
  *out_len = 4 + static_cast<size_t>(der_len);
  return USIG_OK;
}

int usig_sealed_size2(usig_t *u, size_t secret_len, size_t *out) {
  if (u == nullptr || out == nullptr) return USIG_ERR_ARG;
  int der_len = i2d_PrivateKey(u->key, nullptr);
  if (der_len <= 0) return USIG_ERR_CRYPTO;
  *out = (secret_len == 0 ? 4 : kV3Overhead) + static_cast<size_t>(der_len);
  return USIG_OK;
}

int usig_seal2(usig_t *u, const uint8_t *secret, size_t secret_len,
               uint8_t *out, size_t cap, size_t *out_len) {
  if (u == nullptr || out == nullptr || out_len == nullptr)
    return USIG_ERR_ARG;
  if (secret == nullptr || secret_len == 0)
    return usig_seal(u, out, cap, out_len);
  size_t need = 0;
  int rc = usig_sealed_size2(u, secret_len, &need);
  if (rc != USIG_OK) return rc;
  if (cap < need) return USIG_ERR_BUFSZ;
  int der_len = i2d_PrivateKey(u->key, nullptr);
  if (der_len <= 0) return USIG_ERR_CRYPTO;
  std::vector<unsigned char> der(static_cast<size_t>(der_len));
  unsigned char *dp = der.data();
  if (i2d_PrivateKey(u->key, &dp) != der_len) return USIG_ERR_CRYPTO;

  std::memcpy(out, kSealMagicV3, 4);
  unsigned char *salt = out + 4;
  unsigned char *itp = out + 4 + kSaltLen;
  unsigned char *nonce = itp + 4;
  unsigned char *ct = nonce + kNonceLen;
  unsigned char *tag = ct + der_len;
  if (RAND_bytes(salt, static_cast<int>(kSaltLen)) != 1 ||
      RAND_bytes(nonce, static_cast<int>(kNonceLen)) != 1) {
    std::memset(der.data(), 0, der.size());
    return USIG_ERR_CRYPTO;
  }
  for (int i = 0; i < 4; ++i)
    itp[i] = static_cast<unsigned char>(kKdfIters >> (24 - 8 * i));
  unsigned char key[32];
  int ok = kdf_key(secret, secret_len, salt, kKdfIters, key) &&
           gcm_encrypt(key, nonce, der.data(), der_len, ct, tag);
  std::memset(key, 0, sizeof key);
  std::memset(der.data(), 0, der.size());
  if (!ok) return USIG_ERR_CRYPTO;
  *out_len = kV3Overhead + static_cast<size_t>(der_len);
  return USIG_OK;
}

int usig_verify_ui(const uint8_t pub[64], uint64_t epoch_be,
                   const uint8_t digest[32], uint64_t counter,
                   const uint8_t sig[64]) {
  if (pub == nullptr || digest == nullptr || sig == nullptr)
    return USIG_ERR_ARG;
  unsigned char payload[32];
  if (!signed_payload(digest, epoch_be, counter, payload))
    return USIG_ERR_CRYPTO;

  unsigned char pt[65];
  pt[0] = 0x04;
  std::memcpy(pt + 1, pub, 64);
  char group[8] = "P-256";
  OSSL_PARAM params[3];
  params[0].key = "group";
  params[0].data_type = OSSL_PARAM_UTF8_STRING;
  params[0].data = group;
  params[0].data_size = 5;
  params[0].return_size = static_cast<size_t>(-1);
  params[1].key = "pub";
  params[1].data_type = OSSL_PARAM_OCTET_STRING;
  params[1].data = pt;
  params[1].data_size = sizeof pt;
  params[1].return_size = static_cast<size_t>(-1);
  params[2].key = nullptr;
  params[2].data_type = 0;
  params[2].data = nullptr;
  params[2].data_size = 0;
  params[2].return_size = 0;

  EVP_PKEY_CTX *fctx = EVP_PKEY_CTX_new_from_name(nullptr, "EC", nullptr);
  if (fctx == nullptr) return USIG_ERR_CRYPTO;
  EVP_PKEY *pkey = nullptr;
  int ok = EVP_PKEY_fromdata_init(fctx) == 1 &&
           EVP_PKEY_fromdata(fctx, &pkey, EVP_PKEY_PUBLIC_KEY, params) == 1;
  EVP_PKEY_CTX_free(fctx);
  if (!ok || pkey == nullptr) return USIG_ERR_CRYPTO;

  std::vector<unsigned char> der = raw64_to_der(sig);
  EVP_PKEY_CTX *vctx = EVP_PKEY_CTX_new(pkey, nullptr);
  int valid = 0;
  if (vctx != nullptr) {
    valid = EVP_PKEY_verify_init(vctx) == 1 &&
            EVP_PKEY_verify(vctx, der.data(), der.size(), payload, 32) == 1;
    EVP_PKEY_CTX_free(vctx);
  }
  EVP_PKEY_free(pkey);
  return valid ? USIG_OK : USIG_ERR_CRYPTO;
}

}  /* extern "C" */
