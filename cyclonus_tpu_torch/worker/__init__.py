"""The wire model the verdict service speaks (copies of the reference
package's worker/model.py and worker/wireregistry.py): Delta, FlowQuery,
Verdict and the Batch envelope."""
