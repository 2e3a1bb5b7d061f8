"""The plain reference: what a job's output is judged against."""
