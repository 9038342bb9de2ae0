// The audited pops: pop_phase.cu's 24 instantiations with the state
// audit's clock lane, built as their own translation unit (one nvcc job
// beside pop_phase.cu's, so the build does not double in length). Their
// entry points are shadow_pop_phase_aud, shadow_pop_tgen_aud and
// shadow_pop_tor_aud.
#define SHADOW_POP_AUDIT 1
#include "pop_phase.cu"
