/* Native USIG module — public C surface.
 *
 * Mirrors the reference's untrusted shim API (reference
 * usig/sgx/shim/usig.h, shim.c:25-117) over a software trusted component
 * with the exact enclave semantics of reference usig/sgx/enclave/usig.c:
 *
 *  - per-instance ECDSA-P256 keypair + random 64-bit epoch (usig.c:25-27,
 *    181);
 *  - usig_create_ui signs SHA256(digest || epoch_be8 || counter_be8) and
 *    increments the counter only AFTER signing, so a counter value can
 *    never be issued twice (usig.c:36-76, comment at 66-69);
 *  - counters start at 1 (usig.c:181, test usig_test.c:34-60);
 *  - key seal/unseal round-trip (usig.c:107-166), with a FRESH random
 *    epoch drawn on every init — including restores (usig.c:168-186) — so
 *    a restarted instance whose counter restarts at 1 can never
 *    re-certify already-issued (epoch, cv) values.  Without SGX there is
 *    no hardware sealing root; the v3 sealed format instead encrypts the
 *    key with AES-256-GCM under an operator-supplied secret
 *    (PBKDF2-HMAC-SHA256 KDF) so a stolen blob discloses nothing —
 *    the confidentiality property of sgx_seal_data (usig.c:107-116)
 *    under a software root of trust.  Sealing without a secret keeps
 *    the v2 plaintext layout for compatibility.
 *
 * The byte formats match usig/software.py EcdsaUSIG exactly (cert
 * payload, epoch || x || y identity), so UIs created natively verify on
 * the GPU batch path (kernel K2) unchanged.
 */

#ifndef MINBFT_TPU_NATIVE_USIG_H
#define MINBFT_TPU_NATIVE_USIG_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct usig usig_t;

enum {
  USIG_OK = 0,
  USIG_ERR_ALLOC = 1,
  USIG_ERR_CRYPTO = 2,
  USIG_ERR_SEALED = 3, /* malformed sealed blob */
  USIG_ERR_ARG = 4,
  USIG_ERR_BUFSZ = 5,
  USIG_ERR_SECRET = 6, /* encrypted blob: secret missing or wrong */
};

/* Create an instance.  sealed==NULL generates a fresh keypair; otherwise
 * the keypair is restored from a previously sealed blob (reference
 * shim.c:35-57 usig_init with/without sealed data).  Either way the
 * epoch is freshly random (usig.c:177-186). */
int usig_init(usig_t **out, const uint8_t *sealed, size_t sealed_len);
int usig_destroy(usig_t *u);

/* Certify a 32-byte message digest: writes the counter value used and the
 * raw 64-byte (r||s big-endian) ECDSA-P256 signature over
 * SHA256(digest || epoch_be8 || counter_be8).  Thread-safe (internal
 * mutex — the reference serializes enclave calls with ecallLock,
 * usig-enclave.go:105-114). */
int usig_create_ui(usig_t *u, const uint8_t digest[32], uint64_t *counter,
                   uint8_t sig_out[64]);

/* Current epoch (big-endian bytes are the caller's concern). */
int usig_get_epoch(usig_t *u, uint64_t *epoch);

/* Uncompressed public key: 64 bytes x||y big-endian. */
int usig_get_pubkey(usig_t *u, uint8_t out[64]);

/* Two-call seal dance (reference shim.c:84-117): query the size, then
 * seal into a caller buffer. */
int usig_sealed_size(usig_t *u, size_t *out);
int usig_seal(usig_t *u, uint8_t *out, size_t cap, size_t *out_len);

/* Encrypted sealing (v3, sgx_seal_data confidentiality analogue):
 * secret==NULL/len==0 degrades to the plaintext v2 paths above.
 * usig_init2 accepts v3 (requires the right secret), v2 and v1 blobs. */
int usig_init2(usig_t **out, const uint8_t *sealed, size_t sealed_len,
               const uint8_t *secret, size_t secret_len);
int usig_sealed_size2(usig_t *u, size_t secret_len, size_t *out);
int usig_seal2(usig_t *u, const uint8_t *secret, size_t secret_len,
               uint8_t *out, size_t cap, size_t *out_len);

/* Host-side UI verification (used by the C++ test and as a fast serial
 * fallback): pub is x||y (64B), sig is r||s (64B). Returns USIG_OK when
 * valid, USIG_ERR_CRYPTO when not. */
int usig_verify_ui(const uint8_t pub[64], uint64_t epoch_be,
                   const uint8_t digest[32], uint64_t counter,
                   const uint8_t sig[64]);

/* Library build id, for the capability probe. */
const char *usig_native_version(void);

#ifdef __cplusplus
}
#endif

#endif /* MINBFT_TPU_NATIVE_USIG_H */
